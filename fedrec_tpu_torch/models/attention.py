"""Attention modules, the port of ``fedrec_tpu/models/attention.py``.

* ``AdditiveAttention``: learned-query pooling ``fc1 -> tanh -> fc2 ->
  normalize -> weighted sum``; with ``use_pallas`` (and ``stable_softmax``)
  it runs kernel A (``ops.additive_pool``), which omits the
  softmax-invariant fc2 bias.
* ``MultiHeadAttention``: Q/K/V projections and scaled dot-product
  attention with no output projection, through one of three routes
  (``attn_impl``): dense scores, the blockwise ``chunked_attention`` loop,
  or ``flash_attention`` (kernel F1, with F2 and F3 as its backward).

Under a seq world (``seq_group``, ``fed.seq_shards > 1``; the sequence
holds only this rank's shard) both modules take ``parallel.ring``'s
collectives instead: ``AdditiveAttention`` the plain logits into
``seq_parallel_pool`` (kernel A cannot span ranks), ``MultiHeadAttention``
``ring_attention`` or ``ulysses_attention`` (``seq_impl``), bypassing
``attn_impl``. ``seq_parallel(group, ...)`` returns a copy of a module that
shares its parameters and runs that way, as the JAX step's
``model.clone(seq_axis=...)`` does.

Submodule names follow the Flax parameter tree (``att_fc1``, ``w_q``, ...),
so ``params.from_flax`` maps a JAX checkpoint onto them by path. Parameters
are kept in float32; ``dtype`` is the compute dtype, as in Flax's ``Dense``
(inputs, kernel and bias are cast to it before the product).
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from fedrec_tpu_torch.ops import additive_pool, chunked_attention, flash_attention


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``Dense(dtype=...)`` semantics: cast input, weight and bias to
    the compute dtype, then ``x W^T + b``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def seq_clone(module: nn.Module, **attrs) -> nn.Module:
    """A shallow copy of ``module`` that shares its parameters (and, unless
    replaced, its submodules), with ``attrs`` set on the copy only."""
    clone = copy.copy(module)
    clone.__dict__["_modules"] = dict(module._modules)
    clone.__dict__.update(attrs)
    return clone


def _masked_normalize(
    logits: torch.Tensor, mask: torch.Tensor | None, dim: int, stable: bool
) -> torch.Tensor:
    """Reference-style exp-normalization, optionally max-stabilized:
    ``exp(logits) * mask / (sum + 1e-8)``; the mask multiplies AFTER the
    exp, so a fully-masked row normalizes to ~0, not to a uniform row."""
    if stable:
        logits = logits - logits.amax(dim=dim, keepdim=True)
    weights = torch.exp(logits)
    if mask is not None:
        weights = weights * mask
    return weights / (weights.sum(dim=dim, keepdim=True) + 1e-8)


class AdditiveAttention(nn.Module):
    """Learned-query additive pooling over a sequence: (..., L, D) -> (..., D)."""

    def __init__(
        self,
        in_dim: int,
        hidden: int = 200,
        stable_softmax: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        seq_group=None,
    ):
        super().__init__()
        self.att_fc1 = nn.Linear(in_dim, hidden)
        self.att_fc2 = nn.Linear(hidden, 1)
        self.stable_softmax = stable_softmax
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.seq_group = seq_group  # a seq world (parallel.ring.SeqGroup)

    def seq_parallel(self, group) -> "AdditiveAttention":
        return seq_clone(self, seq_group=group)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.seq_group is not None:
            # x holds only this rank's sequence shard; normalise over the world
            from fedrec_tpu_torch.parallel.ring import seq_parallel_pool

            logits = dense(self.att_fc2, torch.tanh(dense(self.att_fc1, x, self.dtype)),
                           self.dtype)[..., 0]
            if mask is not None:
                mask = mask.to(logits.dtype)
            return seq_parallel_pool(x, logits, mask, self.seq_group)
        if self.use_pallas and self.stable_softmax:
            if mask is not None:
                mask = mask.to(torch.float32).contiguous()
            return additive_pool(
                x.contiguous(),
                self.att_fc1.weight.t().contiguous(),
                self.att_fc1.bias,
                self.att_fc2.weight[0].contiguous(),
                mask,
            )
        e = torch.tanh(dense(self.att_fc1, x, self.dtype))
        logits = dense(self.att_fc2, e, self.dtype)[..., 0]  # (..., L)
        if mask is not None:
            mask = mask.to(logits.dtype)
        alpha = _masked_normalize(logits, mask, dim=-1, stable=self.stable_softmax)
        dt = torch.promote_types(alpha.dtype, x.dtype)
        return torch.einsum("...l,...ld->...d", alpha.to(dt), x.to(dt))


class MultiHeadAttention(nn.Module):
    """Multi-head scaled-dot-product attention WITHOUT output projection
    (reference ``attention.py:81``). ``attn_impl`` picks the route; see
    ``ModelConfig.attn_impl``."""

    def __init__(
        self,
        in_dim: int,
        num_heads: int = 20,
        head_dim: int = 20,
        stable_softmax: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        attn_impl: str = "auto",
        chunk_threshold: int = 1024,
        seq_group=None,
        seq_impl: str = "ring",
    ):
        super().__init__()
        d = num_heads * head_dim
        self.w_q = nn.Linear(in_dim, d)
        self.w_k = nn.Linear(in_dim, d)
        self.w_v = nn.Linear(in_dim, d)
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.stable_softmax = stable_softmax
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.attn_impl = attn_impl
        self.chunk_threshold = chunk_threshold
        self.seq_group = seq_group  # a seq world (parallel.ring.SeqGroup)
        self.seq_impl = seq_impl    # "ring" | "ulysses"

    def seq_parallel(self, group, impl: str = "ring") -> "MultiHeadAttention":
        return seq_clone(self, seq_group=group, seq_impl=impl)

    def resolve_impl(self, length: int) -> str:
        """The route for a query length: ``attn_impl`` unless "auto". The
        JAX module's "auto" first asks ``ops.autotune.measured_attn_impl``
        for benchmark evidence; that finds no TPU backend off a TPU and
        returns None, so the port (which never runs on one) applies the
        static defaults that follow it."""
        impl = self.attn_impl
        if impl == "auto":
            if self.use_pallas and self.stable_softmax:
                impl = "pallas"
            elif length > self.chunk_threshold and self.stable_softmax:
                impl = "chunked"
            else:
                impl = "dense"
        if impl not in ("dense", "chunked", "pallas"):
            raise ValueError(f"attn_impl must be auto|dense|chunked|pallas, got {impl!r}")
        return impl

    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        *batch, L, _ = q.shape
        d = self.num_heads * self.head_dim

        def split_heads(x):
            return x.reshape(*batch, -1, self.num_heads, self.head_dim)

        q_s = split_heads(dense(self.w_q, q, self.dtype))  # (..., L, H, Dk)
        k_s = split_heads(dense(self.w_k, k, self.dtype))
        v_s = split_heads(dense(self.w_v, v, self.dtype))
        if self.seq_group is not None:
            # the sequence-sharded path; L is this rank's shard
            from fedrec_tpu_torch.parallel.ring import ring_attention, ulysses_attention

            if self.seq_impl not in ("ring", "ulysses"):
                raise ValueError(f"seq_impl must be 'ring' or 'ulysses', got {self.seq_impl!r}")
            sp = ring_attention if self.seq_impl == "ring" else ulysses_attention
            return sp(q_s, k_s, v_s, mask, self.seq_group).reshape(*batch, L, d)
        impl = self.resolve_impl(L)
        if impl == "pallas":
            # blocked online softmax, kernels F1-F3: no (..., H, L, L) scores
            return flash_attention(q_s, k_s, v_s, mask).reshape(*batch, L, d)
        if impl == "chunked":
            # blockwise loop, O(L) memory
            return chunked_attention(q_s, k_s, v_s, mask).reshape(*batch, L, d)
        scale = torch.sqrt(torch.tensor(self.head_dim, dtype=q_s.dtype, device=q_s.device))
        scores = torch.einsum("...qhd,...khd->...hqk", q_s, k_s) / scale
        if mask is not None:
            # (..., Lk) key mask broadcast over heads and query positions
            mask = mask[..., None, None, :].to(scores.dtype)
        attn = _masked_normalize(scores, mask, dim=-1, stable=self.stable_softmax)
        context = torch.einsum("...hqk,...khd->...qhd", attn, v_s)
        return context.reshape(*batch, L, d)
