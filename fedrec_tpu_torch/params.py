"""The weights bridge between Flax parameter trees and the port's modules.

``from_flax`` loads a tree of numpy arrays shaped like the JAX package's
``NewsRecommender`` params::

    {"user_encoder": {"self_attn": {"w_q"|"w_k"|"w_v": {"kernel", "bias"}},
                      "pool": {"att_fc1": {...}, "att_fc2": {...}}},
     "text_head": {"pool": {"att_fc1": {...}, "att_fc2": {...}},
                   "fc": {"kernel", "bias"}}}

or like a finetune-mode ``TextEncoder``'s (``{"trunk": {...}, "head":
{...}}``, ``models.bert``) into a module whose submodule names follow the
same paths. Three kinds of leaf: a Dense (``{"kernel", "bias"}``, or
``{"kernel"}`` for the GRU's bias-free ``hr`` and ``hz``) loads into an
``nn.Linear``, its (in, out) kernel transposed to the (out, in) weight
(``att_fc2``'s (hidden, 1) kernel becomes a (1, hidden) weight), and a 1-D
Conv's (k, in, out) kernel (the CNN head's ``text_head/conv``) is first
reshaped to (k * in, out), tap-major, the layout of
``models.encoders.CnnTextHead.conv``; an Embed (``{"embedding"}``) into an
``nn.Embedding``; a LayerNorm (``{"scale", "bias"}``) into an
``nn.LayerNorm``, ``scale`` as its weight. The GRU tower's leaves sit under
``user_encoder/GRUCell_0/{ir,iz,in,hr,hz,hn}``, as in the Flax tree.

``to_flax`` is the inverse: the module's leaves as a Flax-layout tree of
numpy arrays. ``flax_leaves`` and ``load_flax_leaves`` do the same on the
device, as one list of tensors in ``jax.tree_util``'s leaf order (keys
sorted depth first: ``bias`` before ``kernel``), the order and layout the
update codecs address a contribution by (``comms.codecs``).

``init_params`` gives a module Flax's default initialisation from a seeded
``torch.Generator``: LeCun-normal Dense and Conv kernels (a Conv's fan-in
is k * in, its ``nn.Linear``'s ``in_features``) and Embed tables
(truncated normal), Xavier-uniform Q/K/V kernels, orthogonal GRU recurrent
kernels (``hr``, ``hz``, ``hn``), zero biases, unit LayerNorm scales.
The draws differ from JAX's own for the same seed; tests that compare the
two load one tree into both.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling's divisor)
_TRUNC_STD = 0.87962566103423978
# the GRU cell's recurrent kernels (flax nn.GRUCell: orthogonal init)
_RECURRENT = ("hr", "hz", "hn")


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    """Yield ``(dotted_path, leaf)`` for every Dense, Embed and LayerNorm in
    the tree."""
    if "kernel" in tree or "embedding" in tree or "scale" in tree:
        yield prefix, tree
        return
    for key, sub in tree.items():
        yield from _leaves(sub, f"{prefix}.{key}" if prefix else key)


def _leaf_tensors(path: str, leaf: Mapping[str, Any], layer: nn.Module) -> dict[str, np.ndarray]:
    """The Flax leaf as the layer's ``{"weight", "bias"}`` (or ``{"weight"}``)."""
    kinds = {"kernel": nn.Linear, "embedding": nn.Embedding, "scale": nn.LayerNorm}
    kind = next(k for k in kinds if k in leaf)
    if not isinstance(layer, kinds[kind]):
        raise KeyError(f"Flax path {path!r} maps to {type(layer).__name__}, "
                       f"not {kinds[kind].__name__}")
    if kind == "kernel":
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kernel.ndim == 3:  # a 1-D Conv: (k, in, out) -> (k * in, out)
            kernel = kernel.reshape(-1, kernel.shape[-1])
        weight = np.array(kernel.T, order="C")
    else:
        weight = np.array(leaf[kind], np.float32)
    out = {"weight": weight}
    if kind == "embedding":
        return out
    if ("bias" in leaf) != (layer.bias is not None):
        raise ValueError(f"{path}: the Flax leaf {'has' if 'bias' in leaf else 'has no'} bias, "
                         f"the {type(layer).__name__} {'has none' if 'bias' in leaf else 'has one'}")
    if "bias" in leaf:
        out["bias"] = np.array(leaf["bias"], np.float32)
    return out


def from_flax(module: nn.Module, tree: Mapping[str, Any]) -> list[str]:
    """Copy the Dense, Embed and LayerNorm leaves of ``tree`` into
    ``module`` in place.

    ``tree`` may be the full ``{"params": {...}}`` variables dict, the params
    dict, or a subtree matching ``module`` (e.g. the ``user_encoder`` subtree
    for a ``UserEncoder``). Returns the loaded paths; raises ``KeyError`` for
    a path the module lacks and ``ValueError`` for a shape mismatch.
    """
    if "params" in tree and "kernel" not in tree:
        tree = tree["params"]
    loaded = []
    with torch.no_grad():
        for path, leaf in _leaves(tree):
            try:
                layer = module.get_submodule(path)
            except AttributeError as e:
                raise KeyError(f"module has no layer for Flax path {path!r}") from e
            for name, value in _leaf_tensors(path, leaf, layer).items():
                target = getattr(layer, name)
                if value.shape != tuple(target.shape):
                    raise ValueError(
                        f"{path}: Flax {name} {value.shape} does not fit "
                        f"{type(layer).__name__}.{name} {tuple(target.shape)}"
                    )
                target.copy_(torch.from_numpy(value))
            loaded.append(path)
    return loaded


def _flax_specs(module: nn.Module) -> list[tuple[tuple[str, ...], torch.Tensor, Any]]:
    """``(flax path, parameter, kernel shape or None)`` for every leaf of
    ``module``, sorted by path (the Flax tree's leaf order). The kernel
    shape is the Flax ``(in, out)`` (or a Conv's ``(k, in, out)``) of a
    Dense's transposed weight; None marks a leaf stored as is."""
    specs = []
    for name, layer in module.named_modules():
        base = tuple(name.split(".")) if name else ()
        if isinstance(layer, nn.Linear):
            out_f, in_f = layer.weight.shape
            # the CNN head's conv: its parent's int ``kernel`` is the tap count
            k = (getattr(module.get_submodule(name.rpartition(".")[0]), "kernel", None)
                 if base[-1:] == ("conv",) else None)
            shape = (k, in_f // k, out_f) if isinstance(k, int) else (in_f, out_f)
            specs.append((base + ("kernel",), layer.weight, shape))
            if layer.bias is not None:
                specs.append((base + ("bias",), layer.bias, None))
        elif isinstance(layer, nn.Embedding):
            specs.append((base + ("embedding",), layer.weight, None))
        elif isinstance(layer, nn.LayerNorm):
            specs.append((base + ("scale",), layer.weight, None))
            specs.append((base + ("bias",), layer.bias, None))
    return sorted(specs, key=lambda s: s[0])


def flax_leaves(module: nn.Module) -> list[torch.Tensor]:
    """The module's parameters in Flax layout and leaf order, as new f32
    tensors on the parameters' device."""
    with torch.no_grad():
        return [(p.t().reshape(shape) if shape is not None else p).detach().to(
                    torch.float32, copy=True).contiguous()
                for _, p, shape in _flax_specs(module)]


def flax_leaf_count(module: nn.Module) -> int:
    """The number of leaves ``flax_leaves`` returns."""
    return len(_flax_specs(module))


def load_flax_leaves(module: nn.Module, leaves) -> None:
    """Copy Flax-layout leaves (``flax_leaves``' order, tensors or numpy)
    into the module's parameters in place."""
    specs = _flax_specs(module)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves for a module of {len(specs)}")
    with torch.no_grad():
        for (path, p, shape), x in zip(specs, leaves):
            x = torch.as_tensor(x)
            want = shape if shape is not None else tuple(p.shape)
            if tuple(x.shape) != tuple(want):
                raise ValueError(f"{'/'.join(path)}: leaf {tuple(x.shape)} does not fit {want}")
            if shape is not None:
                x = x.reshape(-1, shape[-1]).t()
            p.copy_(x)


def to_flax(module: nn.Module) -> dict:
    """The inverse of ``from_flax``: the module's leaves as a nested dict of
    numpy f32 arrays in Flax layout (Dense kernels ``(in, out)``, a Conv's
    ``(k, in, out)``), one host copy."""
    specs = _flax_specs(module)
    leaves = flax_leaves(module)
    flat = (torch.cat([x.reshape(-1) for x in leaves]).cpu().numpy() if leaves
            else np.zeros(0, np.float32))
    out: dict = {}
    offset = 0
    for (path, _, _), x in zip(specs, leaves):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = flat[offset:offset + x.numel()].reshape(tuple(x.shape))
        offset += x.numel()
    return out


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Flax-default initialisation of every ``nn.Linear``, ``nn.Embedding``
    and ``nn.LayerNorm`` in ``module`` from a ``torch.Generator`` seeded
    with ``seed``; returns ``module``."""
    gen = torch.Generator().manual_seed(seed)

    def lecun(shape, fan_in: int) -> torch.Tensor:
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        w = torch.empty(shape, dtype=torch.float32)
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)

    with torch.no_grad():
        for name, layer in module.named_modules():
            if isinstance(layer, nn.Linear):
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("w_q", "w_k", "w_v"):
                    w = torch.empty(layer.weight.shape, dtype=torch.float32)
                    nn.init.xavier_uniform_(w, generator=gen)
                elif leaf in _RECURRENT and name.rsplit(".", 2)[-2] == "GRUCell_0":
                    w = torch.empty(layer.weight.shape, dtype=torch.float32)
                    nn.init.orthogonal_(w, generator=gen)
                else:
                    w = lecun(layer.weight.shape, layer.in_features)
                layer.weight.copy_(w)
                if layer.bias is not None:
                    layer.bias.zero_()
            elif isinstance(layer, nn.Embedding):
                # flax's default_embed_init: variance scaling over the features
                layer.weight.copy_(lecun(layer.weight.shape, layer.embedding_dim))
            elif isinstance(layer, nn.LayerNorm):
                layer.weight.fill_(1.0)
                layer.bias.zero_()
    return module
