"""Fused user tower + scorer: kernel B (``csrc/fused_history_score.cu``) and
its plain version.

``fused_history_score`` is ``fedrec_tpu/ops/fused_hot_path.py``'s function
of the same name, forward only: Q/K/V projections of the (H, D) history,
per-head masked attention, additive pooling to the user vector, and dot
scores against C candidates, in one launch per batch. ``fused_user_vector``
is the serving entry (no candidates).

Numerics follow the JAX kernel (``_hist_forward_core``): every
normalization is the module's exp-normalization (max-subtracted exp, mask
multiplied after exp, ``+ 1e-8``), accumulation is f32, and values are
rounded to the operand dtype at the same points the JAX kernel casts (q/k/v,
attention weights, ctx, e, pool weights, user, scores). Under float32 that
is the dense module chain up to summation order; under bfloat16 it matches
the JAX kernel rather than the dense module.

On CUDA tensors the kernel launches or the call raises; on CPU tensors
``fused_history_score_plain`` runs the same math step by step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fedrec_tpu_torch.ops import _build

_EPS = 1e-8  # the module's denominator epsilon
_LIB = "fused_history_score"
_lib = None


class UserTowerWeights(NamedTuple):
    """The fused kernel's nine weight operands, in the (in, out) layout of
    the Flax Dense kernels; ``pw2`` is ``att_fc2``'s (hidden,) column."""

    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    pw1: torch.Tensor
    pb1: torch.Tensor
    pw2: torch.Tensor

    def to(self, dtype: torch.dtype) -> "UserTowerWeights":
        return UserTowerWeights(*(t.to(dtype).contiguous() for t in self))


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The module's stable exp-normalization over the last axis, f32:
    ``exp(l - max) * mask / (sum + 1e-8)`` — a fully-masked row gives ~0."""
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m) * mask
    return w / (w.sum(dim=-1, keepdim=True) + _EPS)


def fused_history_score_plain(
    x: torch.Tensor,
    cand: torch.Tensor | None,
    mask: torch.Tensor | None,
    w: UserTowerWeights,
    num_heads: int,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(n, H, D) history, (n, C, D) candidates -> ((n, C) scores, (n, D)
    user) in plain PyTorch: the reference for kernel B. All operands share
    x's dtype; results are in that dtype."""
    n, h, d = x.shape
    dt = x.dtype
    dh = d // num_heads

    def rnd(t):  # round through the operand dtype (identity under f32)
        return t.to(dt).float()

    x32 = x.float()
    q, k, v = (
        rnd(x32 @ wm.float() + b.float())
        for wm, b in ((w.wq, w.bq), (w.wk, w.bk), (w.wv, w.bv))
    )
    m = (
        torch.ones((n, h), dtype=torch.float32, device=x.device)
        if mask is None
        else mask.reshape(n, h).float()
    )

    def heads(t):  # (n, H, D) -> (n, nh, H, dh)
        return t.reshape(n, h, num_heads, dh).transpose(1, 2)

    scale = torch.sqrt(torch.tensor(float(dh), dtype=torch.float32, device=x.device))
    s = heads(q) @ heads(k).transpose(-1, -2) / scale          # (n, nh, H, H)
    a = rnd(masked_softmax(s, m[:, None, None, :]))
    ctx = rnd(a @ heads(v)).transpose(1, 2).reshape(n, h, d)   # (n, H, D)
    e = torch.tanh(ctx @ w.pw1.float() + w.pb1.float())        # (n, H, Q)
    lg = rnd(e) @ w.pw2.float()                                # (n, H)
    alpha = rnd(masked_softmax(lg, m))
    user = rnd(torch.einsum("nh,nhd->nd", alpha, ctx))
    scores = None
    if cand is not None:
        scores = torch.einsum("ncd,nd->nc", cand.float(), user).to(dt)
    return scores, user.to(dt)


def _kernel():
    """The built library, its two C functions typed for ctypes."""
    global _lib
    if _lib is None:
        lib = _build.load(_LIB)
        lib.fused_history_score_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.fused_history_score_launch.restype = ctypes.c_int
        lib.fused_history_score_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.fused_history_score_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _launch(x, cand, mask, w: UserTowerWeights, num_heads: int):
    """Kernel B on CUDA tensors: checks, allocates, launches, or raises."""
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_history_score: x must be float32 or bfloat16, got {dt}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_history_score: x must be contiguous (n, H, D), got {tuple(x.shape)}")
    n, h, d = x.shape
    q = w.pw1.shape[-1]
    if d % num_heads or d % 4:
        raise ValueError(f"fused_history_score: D={d} must divide into {num_heads} heads and by 4")
    want = {"wq": (d, d), "bq": (d,), "wk": (d, d), "bk": (d,), "wv": (d, d),
            "bv": (d,), "pw1": (d, q), "pb1": (q,), "pw2": (q,)}
    for name, t in zip(UserTowerWeights._fields, w):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_history_score: {name} must be {want[name]}, got {tuple(t.shape)}")
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_history_score: {name} must be contiguous {dt} on {x.device}")
    c = 0
    if cand is not None:
        if cand.dtype != dt or cand.device != x.device or not cand.is_contiguous():
            raise ValueError(f"fused_history_score: cand must be contiguous {dt} on {x.device}")
        if cand.dim() != 3 or cand.shape[0] != n or cand.shape[2] != d:
            raise ValueError(f"fused_history_score: cand must be ({n}, C, {d}), got {tuple(cand.shape)}")
        c = cand.shape[1]
    if mask is not None:
        if mask.dtype != torch.float32 or mask.device != x.device or not mask.is_contiguous():
            raise ValueError(f"fused_history_score: mask must be contiguous float32 on {x.device}")
        if tuple(mask.shape) != (n, h):
            raise ValueError(f"fused_history_score: mask must be ({n}, {h}), got {tuple(mask.shape)}")
    lib = _kernel()
    need = lib.fused_history_score_smem_bytes(h, d, q, num_heads)
    limit = _build.smem_limit(x.device)
    if need > limit:
        raise ValueError(f"fused_history_score: a row needs {need} B of shared memory, the card allows {limit}")
    user = torch.empty((n, d), dtype=dt, device=x.device)
    scores = torch.empty((n, c), dtype=dt, device=x.device) if c else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_history_score_launch(
            x.data_ptr(), None if cand is None else cand.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in w),
            None if scores is None else scores.data_ptr(), user.data_ptr(),
            n, h, d, c, q, num_heads, 0 if dt == torch.float32 else 1, stream,
        )
    _build.check(err, _LIB)
    fused_history_score.launches += 1
    return scores, user


def fused_history_score(
    his_vecs: torch.Tensor,
    cand_vecs: torch.Tensor | None,
    mask: torch.Tensor | None,
    weights: UserTowerWeights,
    num_heads: int,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Fused user tower + scorer: (..., H, D) history (post-dropout) and
    (..., C, D) candidates -> ((..., C) scores, (..., D) user vector), both
    in the history's dtype; ``cand_vecs=None`` returns ``(None, user)``.

    ``weights`` are cast to the history's dtype and candidates likewise, as
    the JAX function does. ``mask`` optional (..., H), 1 = real click. CUDA
    tensors launch kernel B (one count in ``fused_history_score.launches``);
    CPU tensors take ``fused_history_score_plain``.
    """
    *batch, h, d = his_vecs.shape
    dt = his_vecs.dtype
    x = his_vecs.reshape(-1, h, d)
    n = x.shape[0]
    cand = None
    if cand_vecs is not None:
        cand = cand_vecs.to(dt).reshape(n, -1, d)
    if mask is not None and mask.numel() != n * h:
        raise ValueError(
            f"fused_history_score: mask {tuple(mask.shape)} does not match history "
            f"{tuple(his_vecs.shape)}"
        )
    m = None if mask is None else mask.to(torch.float32).reshape(n, h).contiguous()
    w = weights.to(dt)
    if x.device.type == "cuda":
        scores, user = _launch(x.contiguous(), cand if cand is None else cand.contiguous(), m, w, num_heads)
    elif x.device.type == "cpu":
        scores, user = fused_history_score_plain(x, cand, m, w, num_heads)
    else:
        raise ValueError(f"fused_history_score: unsupported device {x.device}")
    user = user.reshape(*batch, d)
    if scores is not None:
        scores = scores.reshape(*batch, -1)
    return scores, user


fused_history_score.launches = 0


def fused_user_vector(
    his_vecs: torch.Tensor,
    mask: torch.Tensor | None,
    weights: UserTowerWeights,
    num_heads: int,
) -> torch.Tensor:
    """The serving entry: attention + pool in one launch, no candidates;
    the full-catalog product then runs on the returned user vector."""
    return fused_history_score(his_vecs, None, mask, weights, num_heads)[1]
