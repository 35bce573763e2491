"""The weights bridge between Flax parameter trees and the port's modules.

``from_flax`` loads a tree of numpy arrays shaped like the JAX package's
``NewsRecommender`` params::

    {"user_encoder": {"self_attn": {"w_q"|"w_k"|"w_v": {"kernel", "bias"}},
                      "pool": {"att_fc1": {...}, "att_fc2": {...}}},
     "text_head": {"pool": {"att_fc1": {...}, "att_fc2": {...}},
                   "fc": {"kernel", "bias"}}}

into a module whose submodule names follow the same paths. A Flax Dense
kernel is (in, out) and ``nn.Linear.weight`` is (out, in), so kernels are
transposed on the way in (``att_fc2``'s (hidden, 1) kernel becomes a
(1, hidden) weight).

``init_params`` gives a module Flax's default initialisation from a seeded
``torch.Generator``: LeCun-normal Dense kernels (truncated normal),
Xavier-uniform Q/K/V kernels, zero biases. The draws differ from JAX's own
for the same seed; tests that compare the two load one tree into both.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling's divisor)
_TRUNC_STD = 0.87962566103423978


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    """Yield ``(dotted_path, {"kernel", "bias"})`` for every Dense in the tree."""
    if "kernel" in tree:
        yield prefix, tree
        return
    for key, sub in tree.items():
        yield from _leaves(sub, f"{prefix}.{key}" if prefix else key)


def from_flax(module: nn.Module, tree: Mapping[str, Any]) -> list[str]:
    """Copy the Dense layers of ``tree`` into ``module`` in place.

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
            if not isinstance(layer, nn.Linear):
                raise KeyError(f"Flax path {path!r} maps to {type(layer).__name__}, not Linear")
            kernel = np.array(np.asarray(leaf["kernel"], np.float32).T, order="C")
            bias = np.array(leaf["bias"], np.float32)
            if kernel.shape != tuple(layer.weight.shape) or bias.shape != tuple(layer.bias.shape):
                raise ValueError(
                    f"{path}: Flax kernel {kernel.shape[::-1]} / bias {bias.shape} do not fit "
                    f"Linear weight {tuple(layer.weight.shape)} / bias {tuple(layer.bias.shape)}"
                )
            layer.weight.copy_(torch.from_numpy(kernel))
            layer.bias.copy_(torch.from_numpy(bias))
            loaded.append(path)
    return loaded


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Flax-default initialisation of every ``nn.Linear`` in ``module`` from
    a ``torch.Generator`` seeded with ``seed``; returns ``module``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, layer in module.named_modules():
            if not isinstance(layer, nn.Linear):
                continue
            w = torch.empty(layer.weight.shape, dtype=torch.float32)
            if name.rsplit(".", 1)[-1] in ("w_q", "w_k", "w_v"):
                nn.init.xavier_uniform_(w, generator=gen)
            else:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
            layer.weight.copy_(w)
            layer.bias.zero_()
    return module
