"""The train step's fused hot chain, the port of ``fedrec_tpu/ops/fused_hot_path.py``:

* ``fused_history_score`` (kernel B forward, ``csrc/fused_history_score.cu``;
  kernel E backward, ``csrc/fused_history_score_bwd.cu``): Q/K/V projections
  of the (H, D) history, per-head masked attention, additive pooling to the
  user vector, and dot scores against C candidates. Both split the work by
  shape (``csrc/user_tower.cuh``): the row products over all n H history
  rows on the tensor cores (3xTF32 in f32), the attention a block per
  (row, head), the pool a block per row; B's four launches and E's
  recompute and backward each count as one launch.
  ``fused_user_vector`` is the serving entry (no candidates).
* ``fused_gather_encode`` (kernels C and D, ``csrc/fused_gather_encode.cu``):
  the frozen token-state table gather and the additive text head, its
  products on the tensor cores (3xTF32 in f32) over the gathered rows; the
  (U, T, Dh) gather never exists in device memory,
  forward or backward, and the table gets no cotangent (the trunk is frozen).

Numerics follow the JAX kernels: every normalization is the module's
exp-normalization (max-subtracted exp, mask multiplied after exp, ``+ 1e-8``),
accumulation is f32, and values are rounded to the operand dtype at the same
points the JAX kernels cast. Under float32 that is the dense module chain up
to summation order; under bfloat16 it matches the JAX kernels rather than the
dense modules. The backward kernels treat each softmax's max as a constant and
run in f32, as the JAX ones do; the fc2 biases are not kernel inputs (a
softmax-invariant shift, whose gradient is exactly zero).

On CUDA tensors a wrapper launches its kernel or raises; when autograd needs
a gradient, the forward wrapper runs inside a ``torch.autograd.Function``
whose backward is the backward kernel, and otherwise (serving) it launches
directly. On CPU tensors the ``*_plain`` versions run under ordinary autograd,
and the backward wrappers are autograd of them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fedrec_tpu_torch.ops import _build

_EPS = 1e-8  # the module's denominator epsilon
_HIST = "fused_history_score"
_HIST_BWD = "fused_history_score_bwd"
_GATHER = "fused_gather_encode"


class UserTowerWeights(NamedTuple):
    """The fused user tower's nine weight operands, in the (in, out) layout
    of the Flax Dense kernels; ``pw2`` is ``att_fc2``'s (hidden,) column."""

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


class TextHeadWeights(NamedTuple):
    """The fused text head's five operands, (in, out) layout: the pool's
    ``att_fc1`` (Dh, Ah) and bias, ``att_fc2``'s (Ah,) column, and the
    projection ``fc`` (Dh, D) and bias."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    fcw: torch.Tensor
    fcb: torch.Tensor

    def to(self, dtype: torch.dtype) -> "TextHeadWeights":
        return TextHeadWeights(*(t.to(dtype).contiguous() for t in self))


def text_head_weights(text_head, dtype: torch.dtype) -> TextHeadWeights:
    """A ``TextHead``'s operands in ``dtype``, differentiable in its
    parameters; a ``TextHeadWeights`` passes through (cast to ``dtype``)."""
    if isinstance(text_head, TextHeadWeights):
        return text_head.to(dtype)
    p = text_head.pool
    return TextHeadWeights(
        p.att_fc1.weight.t(), p.att_fc1.bias, p.att_fc2.weight[0],
        text_head.fc.weight.t(), text_head.fc.bias,
    ).to(dtype)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The module's stable exp-normalization over the last axis, f32:
    ``exp(l - max) * mask / (sum + 1e-8)`` — a fully-masked row gives ~0."""
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m) * mask
    return w / (w.sum(dim=-1, keepdim=True) + _EPS)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def _check_operands(name: str, pairs, dt: torch.dtype, device) -> None:
    for field, t, shape in pairs:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {field} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {field} must be contiguous {dt} on {device}")


def _dtype_code(name: str, dt: torch.dtype) -> int:
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: operands must be float32 or bfloat16, got {dt}")
    return 0 if dt == torch.float32 else 1


def _smem_check(name: str, need: int, device) -> None:
    limit = _build.smem_limit(device)
    if need > limit:
        raise ValueError(f"{name}: a block needs {need} B of shared memory, the card allows {limit}")


# ======================================================= user tower (B, E)
def fused_history_score_plain(
    x: torch.Tensor,
    cand: torch.Tensor | None,
    mask: torch.Tensor | None,
    w: UserTowerWeights,
    num_heads: int,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(n, H, D) history, (n, C, D) candidates -> ((n, C) scores, (n, D)
    user) in plain PyTorch: the reference for kernel B, and under autograd
    for kernel E. All operands share x's dtype; results are in that dtype."""
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


def _hist_lib() -> ctypes.CDLL:
    return _build.bind(_HIST, {
        "fused_history_score_launch": ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
        "fused_history_score_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_size_t),
        "fused_history_score_scratch_floats": ([ctypes.c_int] * 5, ctypes.c_size_t),
    })


def _hist_bwd_lib() -> ctypes.CDLL:
    return _build.bind(_HIST_BWD, {
        "fused_history_score_bwd_launch": ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
        "fused_history_score_bwd_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_size_t),
        "fused_history_score_bwd_scratch_floats": ([ctypes.c_int] * 5, ctypes.c_size_t),
    })


def _check_tower(name, x, cand, mask, w: UserTowerWeights, num_heads: int) -> tuple[int, int]:
    """Device, dtype, shape and contiguity checks shared by kernels B and E;
    returns (C, Q)."""
    dt = x.dtype
    _dtype_code(name, dt)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (n, H, D), got {tuple(x.shape)}")
    n, h, d = x.shape
    q = w.pw1.shape[-1]
    if d % num_heads or d % 4:
        raise ValueError(f"{name}: D={d} must divide into {num_heads} heads and by 4")
    shapes = {"wq": (d, d), "bq": (d,), "wk": (d, d), "bk": (d,), "wv": (d, d),
              "bv": (d,), "pw1": (d, q), "pb1": (q,), "pw2": (q,)}
    _check_operands(name, [(f, t, shapes[f]) for f, t in zip(UserTowerWeights._fields, w)], dt, x.device)
    c = 0
    if cand is not None:
        if cand.dim() != 3 or cand.shape[0] != n or cand.shape[2] != d:
            raise ValueError(f"{name}: cand must be ({n}, C, {d}), got {tuple(cand.shape)}")
        c = cand.shape[1]
        _check_operands(name, [("cand", cand, (n, c, d))], dt, x.device)
    if mask is not None:
        _check_operands(name, [("mask", mask, (n, h))], torch.float32, x.device)
    return c, q


def _check_row_products(name, x, w: UserTowerWeights, q: int) -> None:
    """What the tensor-core row products of kernels B and E take: x and the
    weight matrices copied four elements at a time (cp.async)."""
    if q % 4:
        raise ValueError(f"{name}: the pool width Q={q} must divide by 4")
    if any(t.data_ptr() % (4 * t.element_size()) for t in (x, w.wq, w.wk, w.wv, w.pw1)):
        raise ValueError(f"{name}: x and the weight matrices must start on a 4-element boundary")


def _launch_hist(x, cand, mask, w: UserTowerWeights, num_heads: int):
    """Kernel B on CUDA tensors: checks, allocates, launches, or raises."""
    c, q = _check_tower(_HIST, x, cand, mask, w, num_heads)
    _check_row_products(_HIST, x, w, q)
    n, h, d = x.shape
    lib = _hist_lib()
    _smem_check(_HIST, lib.fused_history_score_smem_bytes(h, d, q, num_heads), x.device)
    user = torch.empty((n, d), dtype=x.dtype, device=x.device)
    scores = torch.empty((n, c), dtype=x.dtype, device=x.device) if c else None
    scratch = torch.empty(lib.fused_history_score_scratch_floats(n, h, d, q, num_heads),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_history_score_launch(
            x.data_ptr(), None if cand is None else cand.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in w),
            None if scores is None else scores.data_ptr(), user.data_ptr(), scratch.data_ptr(),
            n, h, d, c, q, num_heads, _dtype_code(_HIST, x.dtype), _stream(x.device),
        )
    _build.check(err, _HIST)
    fused_history_score.launches += 1
    return scores, user


def fused_history_score_bwd_plain(x, cand, mask, w: UserTowerWeights, g_scores, g_user, num_heads: int):
    """Autograd of ``fused_history_score_plain``: the reference for kernel E.
    Returns ``(dx, dcand, UserTowerWeights of gradients)``; ``dcand`` is None
    without candidates."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_()
        cl = None if cand is None else cand.detach().requires_grad_()
        wl = UserTowerWeights(*(t.detach().requires_grad_() for t in w))
        scores, user = fused_history_score_plain(xl, cl, mask, wl, num_heads)
        outs, grads = [user], [g_user.to(user.dtype)]
        if cl is not None:
            outs.append(scores)
            grads.append(g_scores.to(scores.dtype))
        leaves = [xl, *([cl] if cl is not None else []), *wl]
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, got)]
    dx = got[0]
    dcand = got[1] if cl is not None else None
    return dx, dcand, UserTowerWeights(*got[-9:])


def fused_history_score_bwd(x, cand, mask, w: UserTowerWeights, g_scores, g_user, num_heads: int):
    """Kernel E: the cotangents of ``fused_history_score``'s (scores, user)
    outputs -> ``(dx, dcand, UserTowerWeights of gradients)``, weight
    gradients in the weights' dtype. CUDA tensors launch the kernel (its
    row products, attention and pool passes and weight sums count as one
    launch in ``fused_history_score_bwd.launches``); CPU tensors take
    ``fused_history_score_bwd_plain``."""
    if x.device.type == "cpu":
        return fused_history_score_bwd_plain(x, cand, mask, w, g_scores, g_user, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"{_HIST_BWD}: unsupported device {x.device}")
    c, q = _check_tower(_HIST_BWD, x, cand, mask, w, num_heads)
    _check_row_products(_HIST_BWD, x, w, q)
    n, h, d = x.shape
    gu = g_user.to(torch.float32).contiguous()
    if tuple(gu.shape) != (n, d):
        raise ValueError(f"{_HIST_BWD}: g_user must be ({n}, {d}), got {tuple(gu.shape)}")
    gs = None
    if c:
        gs = g_scores.to(torch.float32).contiguous()
        if tuple(gs.shape) != (n, c):
            raise ValueError(f"{_HIST_BWD}: g_scores must be ({n}, {c}), got {tuple(gs.shape)}")
    lib = _hist_bwd_lib()
    _smem_check(_HIST_BWD, lib.fused_history_score_bwd_smem_bytes(h, d, q, num_heads), x.device)
    dev = x.device
    scratch = torch.empty(lib.fused_history_score_bwd_scratch_floats(n, h, d, q, num_heads),
                          dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dcand = torch.empty_like(cand) if c else None
    dw = [torch.empty(t.shape, dtype=torch.float32, device=dev) for t in w]
    with torch.cuda.device(dev):
        err = lib.fused_history_score_bwd_launch(
            x.data_ptr(), None if cand is None else cand.data_ptr(),
            None if mask is None else mask.data_ptr(), *(t.data_ptr() for t in w),
            None if gs is None else gs.data_ptr(), gu.data_ptr(), dx.data_ptr(),
            None if dcand is None else dcand.data_ptr(), scratch.data_ptr(),
            *(t.data_ptr() for t in dw),
            n, h, d, c, q, num_heads, _dtype_code(_HIST_BWD, x.dtype), _stream(dev),
        )
    _build.check(err, _HIST_BWD)
    fused_history_score_bwd.launches += 1
    return dx, dcand, UserTowerWeights(*(g.to(t.dtype) for g, t in zip(dw, w)))


fused_history_score_bwd.launches = 0


class _HistScore(torch.autograd.Function):
    """Kernel B forward, kernel E backward; no gradient for the mask."""

    @staticmethod
    def forward(ctx, num_heads, x, cand, mask, *w):
        scores, user = _launch_hist(x, cand, mask, UserTowerWeights(*w), num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, cand, mask, *w)
        if scores is None:  # an autograd.Function returns tensors only
            scores = x.new_empty((x.shape[0], 0))
        return scores, user

    @staticmethod
    def backward(ctx, g_scores, g_user):
        x, cand, mask, *w = ctx.saved_tensors
        dx, dcand, dw = fused_history_score_bwd(
            x, cand, mask, UserTowerWeights(*w), g_scores, g_user, ctx.num_heads
        )
        return (None, dx, dcand, None, *dw)


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
    tensors launch kernel B (one count in ``fused_history_score.launches``),
    with kernel E as its backward when autograd needs one; CPU tensors take
    ``fused_history_score_plain``.
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
        x = x.contiguous()
        cand = None if cand is None else cand.contiguous()
        if _needs_grad(x, cand, *w):
            scores, user = _HistScore.apply(num_heads, x, cand, m, *w)
            scores = scores if cand is not None else None
        else:
            scores, user = _launch_hist(x, cand, m, w, num_heads)
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
    """The serving entry: the user tower (kernel B) without candidates; the
    full-catalog product then runs on the returned user vector."""
    return fused_history_score(his_vecs, None, mask, weights, num_heads)[1]


# ================================================= gather + encode (C, D)
def fused_gather_encode_plain(
    token_states: torch.Tensor,
    uniq: torch.Tensor,
    text_head,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(N, T, Dh) table + (U,) ids -> (U, D) news vectors in plain PyTorch:
    the reference for kernel C, and under autograd for kernel D. Repeats the
    JAX kernel's rounding points: e before the logits, alpha before the
    weighted sum, pooled before fc, the output once."""
    dt = dtype or token_states.dtype
    w = text_head_weights(text_head, dt)

    def rnd(t):
        return t.to(dt).float()

    x32 = token_states.detach()[uniq].to(dt).float()            # (U, T, Dh)
    e = rnd(torch.tanh(x32 @ w.w1.float() + w.b1.float()))      # (U, T, Ah)
    lg = e @ w.w2.float()                                       # (U, T)
    alpha = rnd(masked_softmax(lg, torch.ones_like(lg)))
    pooled = rnd(torch.einsum("ut,utd->ud", alpha, x32))
    return (pooled @ w.fcw.float() + w.fcb.float()).to(dt)


def _gather_lib() -> ctypes.CDLL:
    return _build.bind(_GATHER, {
        "fused_gather_encode_launch": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
        "fused_gather_encode_bwd_launch": ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
        "fused_gather_encode_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_size_t),
        "fused_gather_encode_scratch_floats": ([ctypes.c_int] * 5, ctypes.c_size_t),
        "fused_gather_encode_bwd_scratch_floats": ([ctypes.c_int] * 5, ctypes.c_size_t),
        "fused_gather_encode_tf32_check": ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    })


def _check_gather(name, table, uniq, w: TextHeadWeights) -> tuple[int, int, int, int, int]:
    """Checks shared by kernels C and D; returns (N, T, Dh, Ah, D)."""
    _dtype_code(name, table.dtype)
    if table.dim() != 3 or not table.is_contiguous():
        raise ValueError(f"{name}: the table must be contiguous (N, T, Dh), got {tuple(table.shape)}")
    n, t, dh = table.shape
    ah, d = w.w1.shape[-1], w.fcw.shape[-1]
    if dh % 4 or ah % 4:
        raise ValueError(f"{name}: Dh={dh} and Ah={ah} must divide by 4 (16-byte row copies)")
    if table.data_ptr() % 16 or w.w1.data_ptr() % 16:
        raise ValueError(f"{name}: the table and w1 must start on a 16-byte boundary")
    if uniq.dim() != 1 or uniq.dtype != torch.int64 or uniq.device != table.device or not uniq.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous int64 vector on {table.device}")
    shapes = {"w1": (dh, ah), "b1": (ah,), "w2": (ah,), "fcw": (dh, d), "fcb": (d,)}
    _check_operands(name, [(f, x, shapes[f]) for f, x in zip(TextHeadWeights._fields, w)],
                    table.dtype, table.device)
    _smem_check(name, _gather_lib().fused_gather_encode_smem_bytes(t, dh, ah, d), table.device)
    return n, t, dh, ah, d


def _launch_gather(table, uniq, w: TextHeadWeights) -> torch.Tensor:
    """Kernel C on CUDA tensors: checks, allocates, launches, or raises."""
    n, t, dh, ah, d = _check_gather(_GATHER, table, uniq, w)
    u = uniq.shape[0]
    lib = _gather_lib()
    out = torch.empty((u, d), dtype=table.dtype, device=table.device)
    scratch = torch.empty(lib.fused_gather_encode_scratch_floats(u, t, dh, ah, d),
                          dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        err = lib.fused_gather_encode_launch(
            table.data_ptr(), uniq.data_ptr(), *(x.data_ptr() for x in w), out.data_ptr(),
            scratch.data_ptr(), u, n, t, dh, ah, d, _dtype_code(_GATHER, table.dtype), _stream(table.device),
        )
    _build.check(err, _GATHER)
    fused_gather_encode.launches += 1
    return out


def fused_gather_encode_bwd_plain(token_states, uniq, weights: TextHeadWeights, g) -> TextHeadWeights:
    """Autograd of ``fused_gather_encode_plain`` for the head weights: the
    reference for kernel D."""
    with torch.enable_grad():
        wl = TextHeadWeights(*(t.detach().requires_grad_() for t in weights))
        out = fused_gather_encode_plain(token_states, uniq, wl, token_states.dtype)
        got = torch.autograd.grad(out, list(wl), g.to(out.dtype), allow_unused=True)
    return TextHeadWeights(*(torch.zeros_like(t) if x is None else x for t, x in zip(wl, got)))


def fused_gather_encode_bwd(token_states, uniq, weights: TextHeadWeights, g) -> TextHeadWeights:
    """Kernel D: the cotangent ``g`` (U, D) of ``fused_gather_encode``'s
    output -> the head weights' gradients (dW1, db1, dw2, dfcW, dfcb), in the
    weights' dtype; none for the frozen table. ``weights`` in the table's
    dtype. CUDA tensors launch the kernel (its two stages count as one launch
    in ``fused_gather_encode_bwd.launches``); CPU tensors take
    ``fused_gather_encode_bwd_plain``."""
    if token_states.device.type == "cpu":
        return fused_gather_encode_bwd_plain(token_states, uniq, weights, g)
    if token_states.device.type != "cuda":
        raise ValueError(f"fused_gather_encode_bwd: unsupported device {token_states.device}")
    name = "fused_gather_encode_bwd"
    n, t, dh, ah, d = _check_gather(name, token_states, uniq, weights)
    u = uniq.shape[0]
    gf = g.to(torch.float32).contiguous()
    if tuple(gf.shape) != (u, d):
        raise ValueError(f"{name}: g must be ({u}, {d}), got {tuple(gf.shape)}")
    lib = _gather_lib()
    dev = token_states.device
    scratch = torch.empty(lib.fused_gather_encode_bwd_scratch_floats(u, t, dh, ah, d),
                          dtype=torch.float32, device=dev)
    grads = [torch.empty(x.shape, dtype=torch.float32, device=dev) for x in weights]
    with torch.cuda.device(dev):
        err = lib.fused_gather_encode_bwd_launch(
            token_states.data_ptr(), uniq.data_ptr(), *(x.data_ptr() for x in weights[:4]),
            gf.data_ptr(), scratch.data_ptr(), *(x.data_ptr() for x in grads),
            u, n, t, dh, ah, d, _dtype_code(name, token_states.dtype), _stream(dev),
        )
    _build.check(err, name)
    fused_gather_encode_bwd.launches += 1
    return TextHeadWeights(*(x.to(w.dtype) for x, w in zip(grads, weights)))


fused_gather_encode_bwd.launches = 0


class _GatherEncode(torch.autograd.Function):
    """Kernel C forward, kernel D backward; no cotangent for the table or the ids."""

    @staticmethod
    def forward(ctx, table, uniq, *w):
        ctx.save_for_backward(table, uniq, *w)
        return _launch_gather(table, uniq, TextHeadWeights(*w))

    @staticmethod
    def backward(ctx, g):
        table, uniq, *w = ctx.saved_tensors
        grads = fused_gather_encode_bwd(table, uniq, TextHeadWeights(*w), g)
        return (None, None, *grads)


def fused_gather_encode(
    token_states: torch.Tensor,
    uniq: torch.Tensor,
    text_head,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Fused frozen-table gather + additive text head: (N, T, Dh) table +
    (U,) int64 unique ids -> (U, news_dim) news vectors.

    ``text_head`` is a ``TextHead`` module (or its ``TextHeadWeights``).
    Operands are cast to ``dtype`` (default: the table's dtype) before the
    kernel — the quantization points of the module's ``Dense(dtype=...)``.
    The table never gets a gradient. CUDA tensors launch kernel C (one count
    in ``fused_gather_encode.launches``), with kernel D as its backward when
    autograd needs one; CPU tensors take ``fused_gather_encode_plain``.
    """
    dt = dtype or token_states.dtype
    if token_states.device.type == "cpu":
        return fused_gather_encode_plain(token_states, uniq, text_head, dt)
    if token_states.device.type != "cuda":
        raise ValueError(f"fused_gather_encode: unsupported device {token_states.device}")
    table = token_states.detach().to(dt).contiguous()
    ids = uniq.to(torch.int64).contiguous()
    w = text_head_weights(text_head, dt)
    if _needs_grad(*w):
        return _GatherEncode.apply(table, ids, *w)
    return _launch_gather(table, ids, w)


fused_gather_encode.launches = 0
