"""Additive pooling: kernel A (``csrc/additive_pool.cu``) and its plain version.

``additive_pool`` computes ``softmax(tanh(x W1 + b1) w2 + bias) . x`` over
the sequence axis, the learned-query pooling of ``AdditiveAttention``
(``fedrec_tpu/ops/attention_kernels.py:additive_pool``). The fc2 bias is
not an argument: it shifts every logit equally and cancels in the softmax.
A masked slot gets the bias -1e9, a true softmax follows, and a row with no
valid slot pools to exactly 0 (the module path's multiply-after-exp
semantics).

On a CUDA tensor ``additive_pool`` launches the kernel or raises; on a CPU
tensor it runs ``additive_pool_plain``, which repeats the JAX kernel's math
step by step (f32 throughout, output in x's dtype). When autograd needs a
gradient, the launch runs inside a ``torch.autograd.Function`` whose backward
is autograd of ``additive_pool_plain`` on the saved inputs: a recompute, as
the JAX backward is a dense ``jax.vjp`` (``attention_kernels.py:_pool_bwd``),
not a kernel.
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
    """The built library, its two C functions typed for ctypes."""
    return _build.bind(_LIB, {
        "additive_pool_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int),
        "additive_pool_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_size_t),
    })


def _launch(x, w1, b1, w2, mask) -> torch.Tensor:
    """Kernel A on CUDA tensors: checks, allocates, launches, or raises."""
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
    n = x.numel() // (L * D) if L * D else 0
    if mask is not None:
        if mask.dtype != torch.float32 or mask.device != x.device or not mask.is_contiguous():
            raise ValueError(f"additive_pool: mask must be contiguous float32 on {x.device}")
        if mask.numel() != n * L:
            raise ValueError(f"additive_pool: mask {tuple(mask.shape)} does not match x {tuple(x.shape)}")
    lib = _kernel()
    need = lib.additive_pool_smem_bytes(L, D, Hd)
    limit = _build.smem_limit(x.device)
    if need > limit:
        raise ValueError(f"additive_pool: a row needs {need} B of shared memory, the card allows {limit}")
    out = torch.empty((*batch, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.additive_pool_launch(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            n, L, D, Hd, 0 if x.dtype == torch.float32 else 1, stream,
        )
    _build.check(err, _LIB)
    additive_pool.launches += 1
    return out


class _Pool(torch.autograd.Function):
    """Kernel A forward; backward = autograd of the plain version."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, mask):
        ctx.save_for_backward(x, w1, b1, w2, mask)
        return _launch(x, w1, b1, w2, mask)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((x, w1, b1, w2), ctx.needs_input_grad)]
            out = additive_pool_plain(*leaves, mask)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in leaves), None)


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
    ``mask`` optional (..., L), 1 = keep. CUDA tensors launch kernel A (and
    count one launch in ``additive_pool.launches``), inside an autograd
    function when a gradient is needed; CPU tensors take
    ``additive_pool_plain``.
    """
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2)):
            return _Pool.apply(x, w1, b1, w2, mask)
        return _launch(x, w1, b1, w2, mask)
    if x.device.type == "cpu":
        return additive_pool_plain(x, w1, b1, w2, mask)
    raise ValueError(f"additive_pool: unsupported device {x.device}")


additive_pool.launches = 0
