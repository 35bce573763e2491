"""Attention kernels and their plain versions: the port of
``fedrec_tpu/ops/attention_kernels.py``.

Additive pooling. ``additive_pool`` computes ``softmax(tanh(x W1 + b1) w2 +
bias) . x`` over the sequence axis, the learned-query pooling of
``AdditiveAttention``. The fc2 bias is not an argument: it shifts every
logit equally and cancels in the softmax. A masked slot gets the bias -1e9,
a true softmax follows, and a row with no valid slot pools to exactly 0 (the
module path's multiply-after-exp semantics). On a CUDA tensor it launches
kernel A (``csrc/additive_pool.cu``: the logits as one tensor-core GEMM over
the token rows, then a pass a block per row) or, for rows longer than a
block's shared memory would hold, kernel A2, the same logits pass with each
row's pool split over blocks: the wrapper picks from the shape before the
launch. When autograd needs a
gradient, the launch runs inside a ``torch.autograd.Function`` whose
backward is the vector-Jacobian product of ``additive_pool_plain`` on the
saved inputs: a recompute, as the JAX backward is a dense ``jax.vjp``, not
a kernel.

Flash attention. ``flash_attention`` is multi-head attention in the JAX
``(..., L, H, d)`` layout with an optional key mask, computed blockwise
with an online softmax so the ``(L, L)`` scores never exist. On CUDA
tensors its forward is kernel F1 and its backward kernels F2 (dq) and F3
(dk, dv, dbias), all on the tensor cores (``csrc/flash_attention.cu``), with
``delta = rowsum(g * out)`` taken in f32 between them, as the JAX backward
does.
``flash_forward_plain`` and ``flash_backward_plain`` repeat the kernels'
math and rounding points with dense PyTorch ops.

Per-example gradients. The autograd functions are written in the
``forward`` / ``setup_context`` style with a ``vmap`` rule each, so
``torch.func.vmap(torch.func.grad(...))`` (per-example DP-SGD) runs through
the kernels: a mapped activation's axis folds into the kernel's row axis
(A's pooled rows, F1-F3's B·H), and each kernel launches once for the whole
batch, never once per example. A mapped weight of A raises, naming its
shape (F1-F3 have no weights: q, k, v, the key bias and the backward's
operands are all per row, and all fold).

On a CPU tensor every wrapper runs its plain version and counts nothing; on
a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fedrec_tpu_torch.ops import _build

_NEG_INF = -1e9
_LIB = "additive_pool"


def additive_pool_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., L, D) -> (..., D) in plain PyTorch: the reference for kernel A."""
    *batch, L, D = x.shape
    xf = x.reshape(-1, L, D).float()
    if mask is None:
        bias = torch.zeros(xf.shape[:2], dtype=torch.float32, device=x.device)
    else:
        m = mask.reshape(-1, L)
        bias = torch.where(m > 0, 0.0, _NEG_INF).to(torch.float32)
    e = torch.tanh(xf @ w1.float() + b1.float())
    logits = e @ w2.float() + bias
    alpha = torch.softmax(logits, dim=-1)
    out = torch.einsum("nl,nld->nd", alpha, xf).to(x.dtype)
    if mask is not None:
        has_valid = (mask.reshape(-1, L).sum(-1) > 0).to(out.dtype)
        out = out * has_valid[:, None]
    return out.reshape(*batch, D)


def _kernel():
    """The built library, its C functions typed for ctypes."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(_LIB, {
        "additive_pool_launch": ([p] * 7 + [i] * 5 + [p], i),
        "additive_pool_long_launch": ([p] * 7 + [i] * 5 + [p], i),
        "additive_pool_smem_bytes": ([i] * 3, ctypes.c_size_t),
        "additive_pool_long_smem_bytes": ([i] * 3, ctypes.c_size_t),
        "additive_pool_logit_tiles": ([i], i),
        "additive_pool_hidden_tile": ([i], i),
    })


def additive_pool_kernel_names(hd: int, long: bool = False, dtype: str = "float") -> tuple[str, str]:
    """The CUDA kernels kernel A (``long``: A2) launches at hidden width
    ``hd``, as a profiler names them: the logits pass and the pool pass."""
    nt = _kernel().additive_pool_hidden_tile(hd) // 32
    return (f"pool_logits_kernel<{dtype}, {nt}>",
            f"pool_rows_kernel<{dtype}, {'true' if long else 'false'}>")


def _launch(x, w1, b1, w2, mask) -> torch.Tensor:
    """Kernel A, or A2 for long rows, on CUDA tensors."""
    return _launch_pool(x, w1, b1, w2, mask, long=None)


def _launch_long(x, w1, b1, w2, mask) -> torch.Tensor:
    """Kernel A2 on CUDA tensors, whatever the length."""
    return _launch_pool(x, w1, b1, w2, mask, long=True)


def _launch_pool(x, w1, b1, w2, mask, long: bool | None) -> torch.Tensor:
    """Checks, allocates, launches A or A2 (``long``; None picks from the
    shape), or raises."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"additive_pool: x must be float32 or bfloat16, got {x.dtype}")
    *batch, L, D = x.shape
    Hd = w1.shape[-1]
    if w1.shape != (D, Hd) or b1.shape != (Hd,) or w2.shape != (Hd,):
        raise ValueError(
            f"additive_pool: want w1 ({D}, Hd), b1 (Hd,), w2 (Hd,); got "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}"
        )
    if D % 4:
        raise ValueError(f"additive_pool kernel needs D % 4 == 0, got D={D}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"additive_pool: {name} must be contiguous float32 on {x.device}")
    if not x.is_contiguous():
        raise ValueError("additive_pool: x must be contiguous")
    if x.data_ptr() % (4 * x.element_size()) or w1.data_ptr() % 16:
        raise ValueError("additive_pool: x and w1 must start on a 4-element boundary")
    n = x.numel() // (L * D) if L * D else 0
    if mask is not None:
        if mask.dtype != torch.float32 or mask.device != x.device or not mask.is_contiguous():
            raise ValueError(f"additive_pool: mask must be contiguous float32 on {x.device}")
        if mask.numel() != n * L:
            raise ValueError(f"additive_pool: mask {tuple(mask.shape)} does not match x {tuple(x.shape)}")
    lib = _kernel()
    limit = _build.smem_limit(x.device)
    if long is None:  # A for rows a block could hold whole, A2 for longer ones
        long = lib.additive_pool_smem_bytes(L, D, Hd) > limit
    need = (lib.additive_pool_long_smem_bytes if long else lib.additive_pool_smem_bytes)(L, D, Hd)
    if need > limit:
        raise ValueError(f"additive_pool: a row needs {need} B of shared memory, the card allows {limit}")
    out = torch.empty((*batch, D), dtype=x.dtype, device=x.device)
    # scratch: one partial logit per token row and hidden-unit tile
    logits = torch.empty((lib.additive_pool_logit_tiles(Hd), n * L), dtype=torch.float32,
                         device=x.device)
    launch, counter = ((lib.additive_pool_long_launch, additive_pool_long) if long
                       else (lib.additive_pool_launch, additive_pool))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                     None if mask is None else mask.data_ptr(), out.data_ptr(), logits.data_ptr(),
                     n, L, D, Hd, 0 if x.dtype == torch.float32 else 1, stream)
    _build.check(err, _LIB)
    counter.launches += 1
    return out


def _lead(t: torch.Tensor | None, dim: int | None, batch: int) -> torch.Tensor | None:
    """A mapped operand with its mapped axis moved to the front, ``(B,
    ...)``; an unmapped one broadcast to every example. Contiguous and on a
    16-byte boundary, as the kernels check."""
    if t is None:
        return None
    t = (t.unsqueeze(0).expand(batch, *t.shape) if dim is None else t.movedim(dim, 0)).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _fold(t: torch.Tensor | None, dim: int | None, batch: int) -> torch.Tensor | None:
    """``_lead``, then the mapped axis folded into the leading (row) axis:
    ``(B, n, ...) -> (B*n, ...)``."""
    t = _lead(t, dim, batch)
    return None if t is None else t.reshape(-1, *t.shape[2:])


def _unfold(t: torch.Tensor, batch: int) -> torch.Tensor:
    """``(B*n, ...) -> (B, n, ...)``: the kernel's rows back per example."""
    return t.reshape(batch, -1, *t.shape[1:])


def _refuse_mapped_weights(name: str, in_dims, args) -> None:
    """A kernel folds a mapped activation into its rows, which keeps one
    set of weights for every row. A weight mapped too (one set an example)
    cannot fold: raise, naming it, rather than run a plain version."""
    for i, (d, t) in enumerate(zip(in_dims[1:], args[1:]), 1):
        if d is not None:
            raise ValueError(
                f"{name}: operand {i} of shape {tuple(t.shape)} is mapped (vmap in_dim "
                f"{d}); the kernel takes one set of weights for every row, so only the "
                "activations may be mapped")


class _Pool(torch.autograd.Function):
    """Kernel A or A2 forward; backward = the plain version's vector-Jacobian
    product (``torch.func.vjp`` of ``additive_pool_plain``, which the
    per-example transform can itself map). Under ``torch.func.vmap`` the
    ``vmap`` rule makes the mapped axis of ``x`` (and of ``mask``) one more
    leading axis of the kernel's rows and launches once for the whole
    batch; a mapped weight raises."""

    @staticmethod
    def forward(x, w1, b1, w2, mask, long=False):
        return (_launch_long if long else _launch)(x, w1, b1, w2, mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w1, b1, w2, mask = inputs[:5]
        ctx.save_for_backward(x, w1, b1, w2, mask)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, mask = ctx.saved_tensors
        args = [x, w1, b1, w2]
        need = [i for i in range(4) if ctx.needs_input_grad[i]]

        def plain(*wanted):  # the pool of the inputs that want a gradient
            full = list(args)
            for i, t in zip(need, wanted):
                full[i] = t
            return additive_pool_plain(*full, mask)

        # only those: the frozen token rows' dx would be the largest product
        _, vjp = torch.func.vjp(plain, *(args[i] for i in need))
        got = dict(zip(need, vjp(g)))
        return (*(got.get(i) for i in range(4)), None, None)

    @staticmethod
    def vmap(info, in_dims, x, w1, b1, w2, mask, long=False):
        # the kernel takes any leading axes: the examples are one more
        _refuse_mapped_weights("additive_pool", in_dims, (x, w1, b1, w2))
        b = info.batch_size
        out = _Pool.apply(_lead(x, in_dims[0], b), w1, b1, w2, _lead(mask, in_dims[4], b), long)
        return out, 0


def additive_pool(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Additive pooling (..., L, D) -> (..., D).

    ``w1`` (D, hidden), ``b1`` (hidden,), ``w2`` (hidden,): the two Dense
    layers of ``AdditiveAttention`` in the (in, out) layout, float32.
    ``mask`` optional (..., L), 1 = keep. CUDA tensors launch kernel A (one
    count in ``additive_pool.launches``) or, for rows longer than a
    block's shared memory would hold, kernel A2 (counted in
    ``additive_pool_long.launches``), inside an autograd function when a
    gradient is needed; CPU tensors take ``additive_pool_plain``.
    """
    return _pool(x, w1, b1, w2, mask, False)


def additive_pool_long(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``additive_pool`` through kernel A2 at any length (CUDA tensors);
    ``additive_pool`` takes it by itself where kernel A does not fit."""
    return _pool(x, w1, b1, w2, mask, True)


def _pool(x, w1, b1, w2, mask, long: bool):
    if x.device.type == "cuda":
        return _Pool.apply(x, w1, b1, w2, mask, long)
    if x.device.type == "cpu":
        return additive_pool_plain(x, w1, b1, w2, mask)
    raise ValueError(f"additive_pool: unsupported device {x.device}")


additive_pool.launches = 0
additive_pool_long.launches = 0


# ============================================================ flash attention
_FLASH = "flash_attention"
_MAX_WIDTH = 128  # the widest head the kernels' register rows take


def _scale(dk: int) -> float:
    return 1.0 / (dk ** 0.5)


def flash_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(BH, Lq, dk) x (BH, Lk, dk) x (BH, Lk, dv) + key bias (BH, Lk) ->
    ((BH, Lq, dv) out in q's dtype, (BH, Lq) f32 log-sum-exp), kernel F1's
    math with dense ops: f32 scores, the running max floored at -1e9 and the
    sum at 1e-30 (JAX's starting values), p rounded to v's dtype before
    P.V."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * _scale(q.shape[-1])
    s = s + bias.float()[:, None, :]
    m = s.amax(-1, keepdim=True).clamp(min=_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _flash_bwd_plain(q, k, v, bias, g, lse, delta, dq: bool = True, dkv: bool = True):
    """Kernels F2 (dq) and F3 (dk, dv, dbias) with dense ops, from the
    forward's lse and ``delta = rowsum(g * out)``: ds rounds to the operand
    dtype before dq and dk, p before dv; dbias sums the f32 ds."""
    scale = _scale(q.shape[-1])
    p = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    p = p.add_(bias.float()[:, None, :]).sub_(lse[..., None]).exp_()
    ds = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    ds = ds.sub_(delta[..., None]).mul_(p)
    out_dq = out_dk = out_dv = out_db = None
    if dkv:
        out_dv = torch.einsum("bqk,bqd->bkd", p.to(g.dtype).float(), g.float()).to(v.dtype)
    del p
    if dq:
        out_dq = (torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float()) * scale).to(q.dtype)
    if dkv:
        out_dk = (torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float()) * scale).to(k.dtype)
        out_db = ds.sum(1)
    return out_dq, out_dk, out_dv, out_db


def flash_backward_dq_plain(q, k, v, bias, g, lse, delta) -> torch.Tensor:
    """Kernel F2's dq with dense ops."""
    return _flash_bwd_plain(q, k, v, bias, g, lse, delta, dkv=False)[0]


def flash_backward_dkv_plain(q, k, v, bias, g, lse, delta):
    """Kernel F3's (dk, dv, dbias) with dense ops."""
    return _flash_bwd_plain(q, k, v, bias, g, lse, delta, dq=False)[1:]


def flash_backward_plain(q, k, v, bias, out, lse, g):
    """The flash backward with dense ops: ``(dq, dk, dv, dbias)`` for the
    cotangent ``g`` of ``out``; the reference for kernels F2 and F3."""
    delta = (g.float() * out.float()).sum(-1)
    return _flash_bwd_plain(q, k, v, bias, g, lse, delta)


def _flash_lib() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 5 + [f, i, p]  # bh, lq, lk, dk, dv, scale, dtype, stream
    return _build.bind(_FLASH, {
        "flash_fwd_launch": ([p] * 6 + tail, i),
        "flash_bwd_dq_launch": ([p] * 8 + tail, i),
        "flash_bwd_dkv_launch": ([p] * 10 + tail, i),
        "flash_smem_bytes": ([i] * 3, ctypes.c_size_t),
    })


def _check_flash(name: str, which: int, q, k, v, bias, *rows) -> tuple[int, ...]:
    """Validate the operands of kernel ``which`` (0 F1, 1 F2, 2 F3); ``rows``
    are (name, tensor, shape, dtype) of the backward's extra inputs."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q, k, v must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (BH, L, d)")
    bh, lq, dk = q.shape
    lk, dv = k.shape[1], v.shape[2]
    if not (1 <= dk <= _MAX_WIDTH and 1 <= dv <= _MAX_WIDTH):
        raise ValueError(f"{name}: head widths dk={dk}, dv={dv} must be in [1, {_MAX_WIDTH}]")
    want = [("q", q, (bh, lq, dk), q.dtype), ("k", k, (bh, lk, dk), q.dtype),
            ("v", v, (bh, lk, dv), q.dtype), ("bias", bias, (bh, lk), torch.float32), *rows]
    for field, t, shape, dt in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {field} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {field} must be contiguous {dt} on {q.device}")
    staged = (q, k, v) if which == 0 else (q, k, v, rows[0][1])  # by cp.async
    if any(t.data_ptr() % (4 * t.element_size()) for t in staged):
        raise ValueError(f"{name}: q, k, v and g must start on a 4-element boundary")
    need = _flash_lib().flash_smem_bytes(which, dk, dv)
    limit = _build.smem_limit(q.device)
    if need > limit:
        raise ValueError(f"{name}: a block needs {need} B of shared memory, the card allows {limit}")
    return bh, lq, lk, dk, dv


def _flash_call(name: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, name)


def _dims(bh, lq, lk, dk, dv, dtype):
    return (bh, lq, lk, dk, dv, ctypes.c_float(_scale(dk)), 0 if dtype == torch.float32 else 1)


def _launch_flash_fwd(q, k, v, bias):
    """Kernel F1 on CUDA tensors -> (out, lse), or raise."""
    dims = _check_flash("flash_forward", 0, q, k, v, bias)
    bh, lq, _, _, dv = dims
    out = torch.empty((bh, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    _flash_call("flash_forward", q.device, _flash_lib().flash_fwd_launch,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *_dims(*dims, q.dtype))
    flash_forward.launches += 1
    return out, lse


def _bwd_rows(q, v, g, lse, delta):
    bh, lq, dv = q.shape[0], q.shape[1], v.shape[2]
    return (("g", g, (bh, lq, dv), q.dtype), ("lse", lse, (bh, lq), torch.float32),
            ("delta", delta, (bh, lq), torch.float32))


def _launch_flash_dq(q, k, v, bias, g, lse, delta):
    """Kernel F2 on CUDA tensors -> dq, or raise."""
    dims = _check_flash("flash_backward_dq", 1, q, k, v, bias, *_bwd_rows(q, v, g, lse, delta))
    dq = torch.empty_like(q)
    _flash_call("flash_backward_dq", q.device, _flash_lib().flash_bwd_dq_launch,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(*dims, q.dtype))
    flash_backward_dq.launches += 1
    return dq


def _launch_flash_dkv(q, k, v, bias, g, lse, delta):
    """Kernel F3 on CUDA tensors -> (dk, dv, dbias), or raise."""
    dims = _check_flash("flash_backward_dkv", 2, q, k, v, bias, *_bwd_rows(q, v, g, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    _flash_call("flash_backward_dkv", q.device, _flash_lib().flash_bwd_dkv_launch,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dbias.data_ptr(), *_dims(*dims, q.dtype))
    flash_backward_dkv.launches += 1
    return dk, dv, dbias


def _on_device(name: str, t: torch.Tensor) -> bool:
    """True for CUDA (launch), False for CPU (plain version); else raise."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{name}: unsupported device {t.device}")


def flash_forward(q, k, v, bias) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of ``flash_forward_plain``: kernel F1 on CUDA tensors
    (one count in ``flash_forward.launches``), the plain version on CPU."""
    if _on_device("flash_forward", q):
        return _launch_flash_fwd(q, k, v, bias)
    return flash_forward_plain(q, k, v, bias)


def flash_backward_dq(q, k, v, bias, g, lse, delta) -> torch.Tensor:
    """dq from the forward's ``lse`` and ``delta = rowsum(g * out)`` (f32):
    kernel F2 on CUDA tensors, the plain version on CPU."""
    if _on_device("flash_backward_dq", q):
        return _launch_flash_dq(q, k, v, bias, g, lse, delta)
    return flash_backward_dq_plain(q, k, v, bias, g, lse, delta)


def flash_backward_dkv(q, k, v, bias, g, lse, delta):
    """``(dk, dv, dbias)`` as ``flash_backward_dq`` takes dq: kernel F3 on
    CUDA tensors, the plain version on CPU."""
    if _on_device("flash_backward_dkv", q):
        return _launch_flash_dkv(q, k, v, bias, g, lse, delta)
    return flash_backward_dkv_plain(q, k, v, bias, g, lse, delta)


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


class _FlashBwd(torch.autograd.Function):
    """Kernels F2 (dq) and F3 (dk, dv, dbias) from the forward's ``lse`` and
    ``delta = rowsum(g * out)``. F2 and F3 compute every row's gradients
    from that row alone, so under ``torch.func.vmap`` the ``vmap`` rule
    folds the mapped axis into the rows (an unmapped operand broadcast to
    every example) and launches each kernel once. Not differentiable."""

    @staticmethod
    def forward(q, k, v, bias, g, lse, delta, need_q, need_kvb):
        dq = _launch_flash_dq(q, k, v, bias, g, lse, delta) if need_q else None
        dk = dv = dbias = None
        if need_kvb:
            dk, dv, dbias = _launch_flash_dkv(q, k, v, bias, g, lse, delta)
        return dq, dk, dv, dbias

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias, g, lse, delta, need_q, need_kvb):
        b = info.batch_size
        folded = [_fold(t, d, b) for t, d in zip((q, k, v, bias, g, lse, delta), in_dims)]
        outs = _FlashBwd.apply(*folded, need_q, need_kvb)
        return (tuple(None if t is None else _unfold(t, b) for t in outs),
                tuple(None if t is None else 0 for t in outs))


class _Flash(torch.autograd.Function):
    """Kernel F1 forward, returning ``(out, lse)``; the backward takes delta
    in f32 and launches kernels F2 and F3 (``_FlashBwd``), as ``_flash_bwd``
    does in JAX. Under ``torch.func.vmap`` the ``vmap`` rule folds the
    mapped axis into F1's B·H rows and launches once for the whole batch."""

    @staticmethod
    def forward(q, k, v, bias):
        return _launch_flash_fwd(q, k, v, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(*inputs, out, lse)

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(-1)
        need_q, need_k, need_v, need_b = ctx.needs_input_grad
        dq, dk, dv, dbias = _FlashBwd.apply(q, k, v, bias, g, lse, delta, need_q,
                                            need_k or need_v or need_b)
        return dq, dk if need_k else None, dv if need_v else None, dbias if need_b else None

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias):
        # every operand is per row (F1 has no weights): all of them fold
        b = info.batch_size
        out, lse = _Flash.apply(*(_fold(t, d, b) for t, d in zip((q, k, v, bias), in_dims)))
        return (_unfold(out, b), _unfold(lse, b)), (0, 0)


def _flash(q, k, v, bias) -> torch.Tensor:
    if _on_device("flash_attention", q):
        return _Flash.apply(q, k, v, bias)[0]
    return flash_forward_plain(q, k, v, bias)[0]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Multi-head attention, (..., L, H, d) layout like the Flax module.

    ``q``: (..., Lq, H, dk); ``k``/``v``: (..., Lk, H, d); ``mask``:
    optional (..., Lk) key mask (1 = attend). Returns (..., Lq, H, dv) in
    q's dtype. A masked key gets the bias -1e9 and a row with no valid key
    returns 0, as the module's exp * mask / (sum + eps) does. ``block_q`` and
    ``block_k`` are the JAX kernel's TPU blocking, accepted and ignored.
    CUDA tensors run kernel F1 (F2 and F3 for the gradient); CPU tensors
    run ``flash_forward_plain`` under autograd.
    """
    del block_q, block_k
    *batch, lq, h, dk = q.shape
    lk, dv = k.shape[-3], v.shape[-1]
    bsz = 1
    for b in batch:
        bsz *= b

    def flat(x, L, d):  # (..., L, H, d) -> (B*H, L, d)
        return x.reshape(bsz, L, h, d).transpose(1, 2).reshape(bsz * h, L, d).contiguous()

    qf, kf, vf = flat(q, lq, dk), flat(k, lk, dk), flat(v, lk, dv)
    if mask is None:
        bias = torch.zeros((bsz * h, lk), dtype=torch.float32, device=q.device)
    else:
        m = mask.reshape(bsz, lk).to(torch.float32)
        bias = torch.where(m > 0, 0.0, _NEG_INF).to(torch.float32).repeat_interleave(h, 0)
    out = _flash(qf, kf, vf, bias)
    if mask is not None:
        has_valid = (mask.reshape(bsz, lk).sum(-1) > 0).to(out.dtype)
        out = out * has_valid.repeat_interleave(h)[:, None, None]
    return out.reshape(bsz, h, lq, dv).transpose(1, 2).reshape(*batch, lq, h, dv)
