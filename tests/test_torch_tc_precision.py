"""The precision argument of kernels C and D's tensor-core products, on the CPU.

Kernels C and D (``fedrec_tpu_torch/ops/csrc/fused_gather_encode.cu``,
``wgrad.cuh:wgrad_tc``, ``mma.cuh``) run the text head's two large products
on the tensor cores: the logits' ``x W1`` over K = Dh = 768, and dW1 = X^T dpre
over K = the U x T gathered rows. Under f32 each operand is split into TF32
hi = tf32(a) and lo = tf32(a - hi) (``cvt.rna``: round to nearest, ties
away, 10 mantissa bits) and each product takes three passes (lo hi, hi lo,
hi hi); a bf16 table is exact in TF32, so dW1 takes two (x dpre_lo,
x dpre_hi). This file emulates that operand handling in numpy and holds it
against float64 at the text head's widths (T 50, Dh 768, Ah 384):

* each mma adds its 8 products to the accumulator with truncation toward
  zero (the tensor cores' alignment and normalization; the pessimistic
  model), and every 32-deep chunk is promoted into an f32 total with a
  round-to-nearest add, as the kernels do;
* the bars are ``chip_smoke.py``'s: F32_ATOL = 1e-4 on the logits, and
  GRAD_REL["float32"] = 1e-4 of the largest |dW1| on the weight sum;
* one TF32 pass (what ``allow_tf32`` would give) misses both bars, so the
  test would catch a kernel that dropped the low parts.
"""

import numpy as np
import pytest

F32_ATOL = 1e-4        # chip_smoke.py: f32 outputs against the plain versions
GRAD_REL_F32 = 1e-4    # chip_smoke.py: f32 gradients, of the largest value
K_STEP, CHUNK = 8, 32  # m16n8k8 depth; products per promoted chunk


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 as ``cvt.rna.tf32.f32``: nearest, ties away from
    zero, the low 13 mantissa bits cleared."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32_rna(a)
    return hi, tf32_rna((a - hi).astype(np.float32))


def trunc_f32(v: np.ndarray) -> np.ndarray:
    """float64 -> f32 rounded toward zero: the low 29 of float64's 52
    mantissa bits cleared, then an exact conversion (normal range)."""
    bits = np.ascontiguousarray(v, np.float64).view(np.uint64) & np.uint64(0xFFFFFFFFE0000000)
    return bits.view(np.float64).astype(np.float32)


def tc_matmul(a: np.ndarray, b: np.ndarray, passes: list[tuple[int, int]]) -> np.ndarray:
    """a (M, K) @ b (K, N) as the kernels form it: per 8-deep step, each pass
    (i, j) adds a_parts[i] @ b_parts[j] into a chunk accumulator truncated to
    f32; every 32-deep chunk is added to the f32 total round-to-nearest.
    Part 0 is hi, part 1 lo; a TF32 product of two TF32 values is exact."""
    ap, bp = split(a), split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], CHUNK):
        chunk = np.zeros_like(total)
        for k in range(c0, min(c0 + CHUNK, a.shape[1]), K_STEP):
            for i, j in passes:
                prod = ap[i][:, k:k + K_STEP].astype(np.float64) @ bp[j][k:k + K_STEP].astype(np.float64)
                chunk = trunc_f32(chunk.astype(np.float64) + prod)
        total = (total + chunk).astype(np.float32)
    return total


THREE = [(1, 0), (0, 1), (0, 0)]  # lo hi, hi lo, hi hi: the f32 route
TWO = [(0, 1), (0, 0)]            # x dpre_lo, x dpre_hi: dW1 on a bf16 table
ONE = [(0, 0)]                    # a single TF32 pass


def to_bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest even), kept as f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def test_tf32_rounding_is_cvt_rna():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1.0, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4, -(one + ulp / 2), 3.0e-5],
                 np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got[:5], [1.0, 1.0, one + ulp, one + ulp, -(one + ulp)])
    assert (got.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    hi, lo = split(x)
    # hi + lo carries 22 of the 24 bits: within 2^-21 relative
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x) <= 2.0 ** -21 * np.abs(x))


def _head(rng, ids=4, t=50, dh=768, ah=384):
    x = rng.standard_normal((ids * t, dh)).astype(np.float32)
    w1 = (rng.standard_normal((dh, ah)) / np.sqrt(dh)).astype(np.float32)
    b1 = (rng.standard_normal(ah) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal(ah) / np.sqrt(ah)).astype(np.float32)
    return x, w1, b1, w2


@pytest.mark.parametrize("route,holds", [("three_tf32_passes", True), ("one_tf32_pass", False)])
def test_text_head_logits_against_float64(route, holds):
    """The pool logits tanh(x W1 + b1) . w2 of 4 ids (T 50, Dh 768, Ah 384)."""
    x, w1, b1, w2 = _head(np.random.default_rng(0))
    pre = tc_matmul(x, w1, THREE if route == "three_tf32_passes" else ONE)
    lg = np.tanh(pre + b1).astype(np.float32) @ w2
    ref = np.tanh(x.astype(np.float64) @ w1.astype(np.float64) + b1) @ w2.astype(np.float64)
    err = float(np.abs(lg - ref).max())
    assert (err <= F32_ATOL) == holds, f"{route}: max logit error {err:.3g} against {F32_ATOL}"
    if holds:  # and with room: the kernels add their own reduction order
        assert err <= F32_ATOL / 10


@pytest.mark.parametrize("route,holds", [
    ("f32_three_tf32_passes", True),
    ("bf16_table_two_tf32_passes", True),
    ("f32_one_tf32_pass", False),
])
def test_dw1_sum_against_float64(route, holds):
    """dW1 = X^T dpre over 64 ids x 50 tokens = 3,200 gathered rows."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64 * 50, 768)).astype(np.float32)
    dpre = (rng.standard_normal((64 * 50, 384)) * 1e-3).astype(np.float32)
    if route.startswith("bf16"):
        x = to_bf16(x)
        assert np.array_equal(tf32_rna(x), x)  # exact in TF32: no low part
    passes = {"f32_three_tf32_passes": THREE, "bf16_table_two_tf32_passes": TWO,
              "f32_one_tf32_pass": ONE}[route]
    got = tc_matmul(np.ascontiguousarray(x.T), dpre, passes)
    ref = x.T.astype(np.float64) @ dpre.astype(np.float64)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert (err <= GRAD_REL_F32 * scale) == holds, (
        f"{route}: max dW1 error {err:.3g} against {GRAD_REL_F32} x {scale:.3g}")
