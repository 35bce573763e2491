"""Sequence parallelism: ring attention, Ulysses all-to-all attention and
the seq-sharded additive pool, the port of ``fedrec_tpu/parallel/ring.py``.

A long click history is split over a *seq world* of processes
(``parallel.mesh.seq_group``): rank r holds history columns ``[r L/S, (r+1)
L/S)`` of every batch, and the user tower attends across the world, so
neither the (L, L) scores nor the whole K/V sequence is ever held by one
process. Where the JAX functions take a mesh ``axis_name`` inside
``shard_map``, these take the world's :class:`SeqGroup`:

* :func:`ring_attention`: blockwise online-softmax accumulation while the
  K/V blocks (and the key mask, when there is one) travel around the ring,
  rank r sending to r + 1; no rotation after the last block;
* :func:`ulysses_attention`: an all-to-all from sequence-sharded to
  head-sharded, dense attention over the whole sequence for ``H / S``
  heads, and the inverse all-to-all (``num_heads % S == 0``);
* :func:`seq_parallel_pool`: the additive pool's softmax normalised over
  the whole sequence (a max and two sums across the world), the pooled
  vector identical on every rank.

Numerics are the JAX module's: the finite ``_NEG = -1e30``, the
multiplicative key mask applied after the ``exp``, the ``+1e-8``
denominator, the max-stabilised online softmax in ring order. The block
products are ``torch.einsum``: JAX computes them outside any Pallas kernel.

Autograd. Every rank computes the same loss from replicated values, and
each collective's backward is the transpose that keeps each rank's
cotangents its own: the ring shift's backward shifts the other way, the
all-to-all's is the inverse all-to-all, a sum whose result every rank holds
passes its (replicated) cotangent through unchanged, and the max is taken
on detached logits (JAX's ``stop_gradient``). Every rank issues the
backward's collectives in the same order, since every rank runs the same
graph. The caller sums the replicated parameters' gradients over the world
once (``SeqGroup.sum``) and scales the replicated candidates' cotangent by
1/S before it (``train.step``).

The wire. One rule picks it: gloo, always. The ranks of a seq world share
one card on the machines this port runs on, and NCCL wants a card per rank
(ROADMAP.md's Queue A item 9). A CUDA tensor is staged explicitly through
pinned host buffers, one device-to-host copy out and one host-to-device
copy in a hop; a CPU tensor goes straight to gloo. Sums are an all-gather
then a sum in rank order on every rank, so every rank holds the same bits.
Each operation's calls, bytes sent and wall milliseconds (staging
included) are counted in ``SeqGroup.stats``.
"""

from __future__ import annotations

import time
from typing import Any

import torch
import torch.distributed as dist

_NEG = -1e30  # finite "-inf": keeps fully-masked blocks NaN-free


class SeqGroup:
    """One process's seat in a seq world: ``rank`` of ``size``, the gloo
    process group ``pg`` (None for a world of one), and the wire's counters:
    ``stats[op] = {"calls", "bytes", "ms"}`` for ``ring_hop``,
    ``all_to_all``, ``all_gather``, ``sum``, ``max`` and ``broadcast``."""

    def __init__(self, rank: int, size: int, pg: Any = None):
        if size > 1 and pg is None:
            raise ValueError(f"a seq world of {size} needs a process group")
        self.rank, self.size, self.pg = int(rank), int(size), pg
        self.stats: dict[str, dict[str, float]] = {}
        self._pinned: dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------ staging
    def reset_stats(self) -> None:
        self.stats = {}

    def _count(self, op: str, nbytes: int, t0: float) -> None:
        s = self.stats.setdefault(op, {"calls": 0, "bytes": 0, "ms": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["ms"] += (time.perf_counter() - t0) * 1e3

    def _host(self, slot: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host buffer for ``slot``, grown on demand, viewed as
        ``shape``."""
        n = 1
        for d in shape:
            n *= int(d)
        buf = self._pinned.get((slot, dtype))
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
            self._pinned[(slot, dtype)] = buf
        return buf[:n].view(shape)

    def _out(self, x: torch.Tensor, slot: str) -> torch.Tensor:
        """``x`` as a host tensor gloo may read: a CPU tensor as it is, a
        CUDA tensor copied into a pinned buffer (one device-to-host copy)."""
        x = x.contiguous()
        if x.device.type == "cpu":
            return x
        buf = self._host(slot, x.shape, x.dtype)
        buf.copy_(x)
        return buf

    def _in_buffer(self, like: torch.Tensor, slot: str, shape=None) -> torch.Tensor:
        shape = tuple(like.shape) if shape is None else tuple(shape)
        if like.device.type == "cpu":
            return torch.empty(shape, dtype=like.dtype)
        return self._host(slot, shape, like.dtype)

    @staticmethod
    def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received host tensor on ``like``'s device (one host-to-device
        copy, complete before the pinned buffer is reused)."""
        if like.device.type == "cpu":
            return host
        return host.to(like.device)

    # -------------------------------------------------------- collectives
    def shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Send ``x`` to rank ``rank + step`` and return what rank ``rank -
        step`` sent (one ring hop, all ranks together)."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        send = self._out(x, "hop_out")
        recv = self._in_buffer(x, "hop_in")
        dst, src = (self.rank + step) % self.size, (self.rank - step) % self.size
        ws = self.pg.send([send], dst, 0)
        wr = self.pg.recv([recv], src, 0)
        ws.wait()
        wr.wait()
        out = self._back(recv, x).view(x.shape)
        self._count("ring_hop", x.numel() * x.element_size(), t0)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of shape (size, ...): chunk j goes to rank j; returns the
        (size, ...) chunks received, chunk j from rank j."""
        if self.size == 1:
            return x
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all wants a leading dim of {self.size}, got {tuple(x.shape)}")
        t0 = time.perf_counter()
        send = self._out(x, "a2a_out")
        recv = self._in_buffer(x, "a2a_in")
        self.pg.alltoall_base(recv, send, [], [], dist.AllToAllOptions()).wait()
        out = self._back(recv, x)
        self._count("all_to_all", x.numel() * x.element_size(), t0)
        return out

    def _gather(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order, (size, *x.shape), on
        ``x``'s device."""
        if self.size == 1:
            return x[None]
        t0 = time.perf_counter()
        send = self._out(x, "gather_out")
        recv = self._in_buffer(x, "gather_in", (self.size, *x.shape))
        self.pg.allgather([list(recv.unbind(0))], [send]).wait()
        out = self._back(recv, x)
        self._count(op, x.numel() * x.element_size(), t0)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x, "all_gather")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, added in rank order on every rank:
        the same bits everywhere."""
        if self.size == 1:
            return x
        parts = self._gather(x, "sum")
        out = parts[0]
        for i in range(1, self.size):
            out = out + parts[i]
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x``."""
        if self.size == 1:
            return x
        return self._gather(x, "max").amax(0)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (same shape and dtype everywhere)."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        buf = self._out(x, "bcast").clone() if x.device.type == "cpu" else self._out(x, "bcast")
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self.pg.broadcast([buf], opts).wait()
        out = self._back(buf, x)
        self._count("broadcast", x.numel() * x.element_size(), t0)
        return out


# ------------------------------------------------------ autograd wrappers
class _RingShift(torch.autograd.Function):
    """One ring hop of several same-dtype tensors in one buffer; the
    backward sends the cotangents of those that want one the other way."""

    @staticmethod
    def forward(ctx, group: SeqGroup, *tensors):
        ctx.group = group
        ctx.shapes = [t.shape for t in tensors]
        ctx.like = tensors[0]
        ctx.grad_ix = [i for i, t in enumerate(tensors) if ctx.needs_input_grad[1 + i]]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        parts = group.shift(flat, 1).split([t.numel() for t in tensors])
        outs = tuple(p.view(s) for p, s in zip(parts, ctx.shapes))
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs) if i not in ctx.grad_ix))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * len(ctx.shapes)
        if ctx.grad_ix:
            gs = [ctx.like.new_zeros(ctx.shapes[i]) if grads[i] is None else grads[i]
                  for i in ctx.grad_ix]
            flat = torch.cat([g.reshape(-1) for g in gs])
            parts = ctx.group.shift(flat, -1).split([g.numel() for g in gs])
            for i, p in zip(ctx.grad_ix, parts):
                out[i] = p.view(ctx.shapes[i])
        return (None, *out)


def _seq_to_heads(group: SeqGroup, x: torch.Tensor) -> torch.Tensor:
    """(*b, L/S, H, D) -> (*b, L, H/S, D): rank r keeps head group r of every
    rank's positions, concatenated in rank order."""
    n = group.size
    *b, ls, h, d = x.shape
    xs = x.reshape(*b, ls, n, h // n, d).movedim(-3, 0)       # (n, *b, ls, h/n, d)
    out = group.all_to_all(xs.contiguous()).movedim(0, len(b))  # (*b, n, ls, h/n, d)
    return out.reshape(*b, n * ls, h // n, d)


def _heads_to_seq(group: SeqGroup, x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`: (*b, L, H/S, D) -> (*b, L/S, H, D)."""
    n = group.size
    *b, L, hs, d = x.shape
    xs = x.reshape(*b, n, L // n, hs, d).movedim(len(b), 0)    # (n, *b, ls, hs, d)
    out = group.all_to_all(xs.contiguous()).movedim(0, -3)       # (*b, ls, n, hs, d)
    return out.reshape(*b, L // n, n * hs, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: SeqGroup, x):
        ctx.group = group
        return _seq_to_heads(group, x)

    @staticmethod
    def backward(ctx, g):
        return None, _heads_to_seq(ctx.group, g)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: SeqGroup, x):
        ctx.group = group
        return _heads_to_seq(group, x)

    @staticmethod
    def backward(ctx, g):
        return None, _seq_to_heads(ctx.group, g)


class _SeqSum(torch.autograd.Function):
    """A sum over the world whose result every rank holds and uses alike:
    each rank's cotangent is already the whole one, and passes through."""

    @staticmethod
    def forward(ctx, group: SeqGroup, x):
        return group.sum(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def _gather_seq(group: SeqGroup, mask: torch.Tensor) -> torch.Tensor:
    """(*b, L/S) -> (*b, L): every rank's key-mask block in rank order."""
    parts = group.all_gather(mask)                               # (n, *b, ls)
    return parts.movedim(0, -2).reshape(*mask.shape[:-1], -1)


def _scale(dk: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(1.0 / (dk ** 0.5), dtype=dtype, device=device)


# ------------------------------------------------------------ the functions
def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None, group: SeqGroup) -> torch.Tensor:
    """Ring attention over a seq world.

    ``q``: (..., Lq_shard, H, Dk), ``k``, ``v``: (..., Lk_shard, H, Dk/Dv),
    this rank's blocks; ``mask``: optional (..., Lk_shard) key mask (1 =
    attend), rotating with K/V. Returns (..., Lq_shard, H, Dv): dense
    attention over the whole sequence, without gathering it."""
    n = group.size
    *batch, lq, h, dk = q.shape
    dv = v.shape[-1]
    scale = _scale(dk, q.dtype, q.device)
    if mask is not None:
        mask = mask.to(q.dtype)
    m = torch.full((*batch, h, lq), _NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros((*batch, h, lq), dtype=q.dtype, device=q.device)
    o = torch.zeros((*batch, lq, h, dv), dtype=q.dtype, device=q.device)
    k_b, v_b, mask_b = k, v, mask
    for i in range(n):
        s = torch.einsum("...qhd,...khd->...hqk", q, k_b) * scale
        if mask_b is not None:
            s = torch.where(mask_b[..., None, None, :] > 0, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if mask_b is not None:
            p = p * mask_b[..., None, None, :]
        corr = torch.exp(m - m_new)                              # (..., H, Lq)
        l = l * corr + p.sum(-1)
        o = o * corr.movedim(-2, -1)[..., None] + torch.einsum("...hqk,...khd->...qhd", p, v_b)
        m = m_new
        # the last block's rotation would be discarded: no hop
        if i < n - 1:
            if mask_b is None:  # the maskless path moves K/V only
                k_b, v_b = _RingShift.apply(group, k_b, v_b)
            else:
                k_b, v_b, mask_b = _RingShift.apply(group, k_b, v_b, mask_b)
    return o / (l.movedim(-2, -1)[..., None] + 1e-8)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor | None, group: SeqGroup) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) attention over a seq world: the same
    layout and result as :func:`ring_attention`; ``num_heads`` must divide
    by the world's size. Q, K and V cross in one all-to-all."""
    n = group.size
    *batch, lq, h, dk = q.shape
    if h % n != 0:
        raise ValueError(f"num_heads={h} not divisible by axis size {n}")
    q_g, k_g, v_g = _SeqToHeads.apply(group, torch.stack([q, k, v])).unbind(0)
    mask_g = bias = None
    if mask is not None:
        mask_g = _gather_seq(group, mask.to(q.dtype))
        bias = torch.where(mask_g[..., None, None, :] > 0, 0.0, _NEG).to(q.dtype)
    s = torch.einsum("...qhd,...khd->...hqk", q_g, k_g) * _scale(dk, q.dtype, q.device)
    if bias is not None:
        s = s + bias
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    if mask_g is not None:
        p = p * mask_g[..., None, None, :]
    p = p / (p.sum(-1, keepdim=True) + 1e-8)
    o = torch.einsum("...hqk,...khd->...qhd", p, v_g)
    return _HeadsToSeq.apply(group, o)


def seq_parallel_pool(x: torch.Tensor, logits: torch.Tensor, mask: torch.Tensor | None,
                      group: SeqGroup) -> torch.Tensor:
    """Additive-attention pooling across a seq world.

    ``x``: (..., L_shard, D) values; ``logits``: (..., L_shard) unnormalised
    scores (the local ``fc2(tanh(fc1 x))``); ``mask``: optional (...,
    L_shard). The max and the denominator run over the whole sequence;
    returns the pooled (..., D) vector, the same on every rank. The
    denominator's and the weighted sum's sums cross in one collective."""
    if mask is not None:
        logits = torch.where(mask > 0, logits, _NEG)
    # the max shift is softmax-invariant: no gradient flows through it
    g_max = group.max(logits.detach().amax(-1))                  # (...)
    w = torch.exp(logits - g_max[..., None])
    if mask is not None:
        w = w * mask.to(w.dtype)
    dt = torch.promote_types(w.dtype, x.dtype)
    local = torch.einsum("...l,...ld->...d", w.to(dt), x.to(dt))
    both = _SeqSum.apply(group, torch.cat([w.sum(-1, keepdim=True).to(dt), local], -1))
    return both[..., 1:] / (both[..., :1] + 1e-8)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity forward; scales the cotangent by ``s`` on the way back (the
    replicated candidate encode's 1/S before the world's gradient sum)."""
    return _ScaleGrad.apply(x, s)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None
