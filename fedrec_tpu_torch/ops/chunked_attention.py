"""Blockwise (chunked) attention: the port of ``fedrec_tpu/ops/chunked_attention.py``.

Dense attention holds ``(B, heads, L, L)`` scores, which at long histories
no longer fit (L=2048 at B=64 x 20 heads is 21 GB in f32). This is the
route ``attn_impl="auto"`` takes past ``attn_chunk_threshold`` when
``use_pallas`` is off: a loop over query blocks and, inside it, over key
blocks with an online softmax; each key step runs under
``torch.utils.checkpoint`` (where JAX uses ``jax.checkpoint``), so the
backward recomputes a block's scores instead of storing them. Nothing of
size ``L x L`` is ever resident.

The JAX module is a ``lax.scan``, not a Pallas kernel, so this port is plain
PyTorch and has no hand-written kernel. Numerics match ``flash_attention``:
stable softmax in f32, an additive -1e9 key bias for the mask, fully-masked
rows return 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e9


def _pad_axis(x: torch.Tensor, axis: int, mult: int, value: float = 0.0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths, value=value)


def _kv_step(qb, kb, vb, bb, m, l, acc, scale: float):
    """One key block of the online softmax: (m, l, acc) -> updated."""
    s = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float()) * scale + bb[:, None, None, :]
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
    return m_new, l_new, acc_new


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    block_q: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """Multi-head attention, (..., L, H, D) layout like the Flax module.

    ``q``: (..., Lq, H, Dk); ``k``/``v``: (..., Lk, H, Dv); ``mask``:
    optional (..., Lk) key mask (1 = attend). Returns (..., Lq, H, Dv) in
    q's dtype. Peak memory is O(block_q * block_k) scores per step.
    """
    *batch, lq, h, dk = q.shape
    lk, dv = k.shape[-3], v.shape[-1]
    bsz = 1
    for b in batch:
        bsz *= b
    qf = q.reshape(bsz, lq, h, dk)
    kf = k.reshape(bsz, lk, h, dk)
    vf = v.reshape(bsz, lk, h, dv)
    if mask is None:
        bias = torch.zeros((bsz, lk), dtype=torch.float32, device=q.device)
    else:
        m = mask.reshape(bsz, lk)
        bias = torch.where(m > 0, 0.0, _NEG_INF).to(torch.float32)

    block_q = min(block_q, max(lq, 1))
    block_k = min(block_k, max(lk, 1))
    # padded keys carry the -1e9 bias, so they never win the softmax
    qp = _pad_axis(qf, 1, block_q)
    kp = _pad_axis(kf, 1, block_k)
    vp = _pad_axis(vf, 1, block_k)
    biasp = _pad_axis(bias, 1, block_k, value=_NEG_INF)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k
    scale = 1.0 / (dk ** 0.5)
    remat = torch.is_grad_enabled()

    outs = []
    for i in range(nq):
        qb = qp[:, i * block_q:(i + 1) * block_q].float()
        m_ = torch.full((bsz, h, block_q), _NEG_INF, dtype=torch.float32, device=q.device)
        l_ = torch.zeros((bsz, h, block_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bsz, h, block_q, dv), dtype=torch.float32, device=q.device)
        for j in range(nk):
            sl = slice(j * block_k, (j + 1) * block_k)
            args = (qb, kp[:, sl], vp[:, sl], biasp[:, sl], m_, l_, acc, scale)
            if remat:
                # the backward recomputes this block's scores from its inputs
                m_, l_, acc = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                m_, l_, acc = _kv_step(*args)
        outs.append((acc / l_.clamp(min=1e-30)[..., None]).transpose(1, 2))
    out = torch.cat(outs, 1)[:, :lq].to(q.dtype)
    if mask is not None:
        has_valid = (mask.reshape(bsz, lk).sum(-1) > 0).to(out.dtype)
        out = out * has_valid[:, None, None, None]
    return out.reshape(*batch, lq, h, dv)
