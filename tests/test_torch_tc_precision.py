"""The precision argument of the kernels' tensor-core products, on the CPU.

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

Kernel A (``csrc/additive_pool.cu``) forms the pool's logits the same way
at (D 768 -> Hd 384) and (400 -> 200, whose last 32-deep chunk is 16 deep
and zero-filled): three passes for an f32 x, two for a bf16 x (exact in
TF32; W1 split), held at f32's 1e-5 bar. Kernel F1
(``csrc/flash_attention.cu``) forms Q K^T (width 20 padded to 24) and P V
(P split like any operand, each 64-key tile's product summed in a fresh
accumulator and added to the rescaled output) inside an f32 online softmax
over 64-key tiles: ``out`` within 1e-5 and ``lse`` within 1e-4 of float64.

Kernel E (``csrc/fused_history_score_bwd.cu``) forms its row products the
same way: the recompute x [Wq|Wk|Wv] (K = 400, three passes; bf16 x and W
exact, one) within the f32 output bar, and dx = dY [Wq|Wk|Wv]^T (K = 1,200;
the f32 cotangents split against an exact bf16 W, two passes) within
GRAD_REL_F32. Kernel F3 (``csrc/flash_attention.cu``) forms S^T, dP^T,
dV = P^T dO and dK = dS^T Q of one 64-key tile over 2,048 queries at width
20 (P^T and dS^T split like any operand, every 32 queries promoted): dK, dV
and dbias within GRAD_REL_F32 of float64. One TF32 pass misses each bar.
Kernel F2 (the same file) forms S = Q K^T and dP = dO V^T (a fresh
accumulator every 8 of its depth) of one 64-query tile in 64-key tiles over
2,048 keys at width 20, and dQ = dS K with a fresh accumulator every 32 keys
(dS split like any operand): dQ within GRAD_REL_F32 of float64, which one
TF32 pass misses. ``test_flash_dq_of_one_key`` holds dP's step-wise
accumulation at width 64 against the case where dS cancels to zero.
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


def tc_matmul(a: np.ndarray, b: np.ndarray, passes: list[tuple[int, int]],
              chunk_depth: int = CHUNK) -> np.ndarray:
    """a (M, K) @ b (K, N) as the kernels form it: per 8-deep step, each pass
    (i, j) adds a_parts[i] @ b_parts[j] into a chunk accumulator truncated to
    f32; every ``chunk_depth``-deep chunk is added to the f32 total
    round-to-nearest. Part 0 is hi, part 1 lo; a TF32 product of two TF32
    values is exact."""
    ap, bp = split(a), split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], chunk_depth):
        chunk = np.zeros_like(total)
        for k in range(c0, min(c0 + chunk_depth, a.shape[1]), K_STEP):
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


F32_BAR = 1e-5  # the kernels' f32 bar against their plain versions (tests/test_torch_gpu.py)


def _pad_cols(a: np.ndarray, mult: int) -> np.ndarray:
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, (-a.shape[-1]) % mult)])


@pytest.mark.parametrize("width", ["768_to_384", "400_to_200"])
@pytest.mark.parametrize("route,holds", [
    ("f32_three_tf32_passes", True),
    ("bf16_x_two_tf32_passes", True),
    ("f32_one_tf32_pass", False),
])
def test_pool_logits_against_float64(width, route, holds):
    """Kernel A's logits tanh(x W1 + b1) . w2 over 4 rows of 50 tokens."""
    d, hd = {"768_to_384": (768, 384), "400_to_200": (400, 200)}[width]
    x, w1, b1, w2 = _head(np.random.default_rng(2), dh=d, ah=hd)
    passes = {"f32_three_tf32_passes": THREE, "bf16_x_two_tf32_passes": TWO,
              "f32_one_tf32_pass": ONE}[route]
    if route.startswith("bf16"):
        x = to_bf16(x)
        assert np.array_equal(tf32_rna(x), x)  # exact in TF32: no low part
    # the kernel zero-fills the depth to whole 32-deep chunks (D = 400: the
    # last is 16 deep); the zeros add nothing
    pre = tc_matmul(_pad_cols(x, CHUNK), _pad_cols(w1.T, CHUNK).T, passes)
    if d % CHUNK:
        assert np.array_equal(pre, tc_matmul(x, w1, passes))
    lg = np.zeros(x.shape[0], np.float32)
    for j in range(hd):  # the epilogue's f32 sum of tanh(pre + b1) w2
        lg = (lg + np.tanh(pre[:, j] + b1[j]) * w2[j]).astype(np.float32)
    ref = np.tanh(x.astype(np.float64) @ w1.astype(np.float64) + b1) @ w2.astype(np.float64)
    err = float(np.abs(lg - ref).max())
    assert (err <= F32_BAR) == holds, f"{route}: max logit error {err:.3g} against {F32_BAR}"


def _flash_emulated(q, k, v, bias, passes):
    """Kernel F1 on one 64-query tile: Q K^T and P V in TF32 passes (width
    padded to 24), the f32 online softmax over 64-key tiles from a running
    max of -1e9, each tile's P V promoted into the rescaled output."""
    f32 = np.float32
    scale = f32(1.0 / np.sqrt(q.shape[1]))
    qp, kp, vp = _pad_cols(q, K_STEP), _pad_cols(k, K_STEP), _pad_cols(v, K_STEP)
    m = np.full(q.shape[0], -1e9, f32)
    l = np.zeros(q.shape[0], f32)
    acc = np.zeros((q.shape[0], vp.shape[1]), f32)
    for k0 in range(0, k.shape[0], 64):
        s = tc_matmul(qp, np.ascontiguousarray(kp[k0:k0 + 64].T), passes)
        s = (s.astype(np.float64) * scale + bias[k0:k0 + 64]).astype(f32)  # one rounding: fmaf
        mx = np.maximum(m, s.max(1))
        corr = np.exp(m - mx)
        p = np.exp(s - mx[:, None])
        l = (l.astype(np.float64) * corr + p.sum(1, dtype=f32)).astype(f32)
        acc = (acc * corr[:, None]).astype(f32)
        acc = (acc + tc_matmul(p, vp[k0:k0 + 64], passes, chunk_depth=64)).astype(f32)
        m = mx
    ls = np.maximum(l, f32(1e-30))
    return (acc / ls[:, None])[:, :v.shape[1]], m + np.log(ls)


@pytest.mark.parametrize("route,holds", [("three_tf32_passes", True), ("one_tf32_pass", False)])
def test_flash_forward_against_float64(route, holds):
    """Kernel F1 at width 20: 64 queries against 2,048 keys, a quarter of
    them masked (bias -1e9)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((n, 20)).astype(np.float32) for n in (64, 2048, 2048))
    bias = np.where(rng.random(2048) > 0.25, 0.0, -1e9).astype(np.float32)
    out, lse = _flash_emulated(q, k, v, bias, THREE if route == "three_tf32_passes" else ONE)
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) / np.sqrt(20) + bias
    ref_lse = s.max(1) + np.log(np.exp(s - s.max(1, keepdims=True)).sum(1))
    ref = np.exp(s - ref_lse[:, None]) @ v.astype(np.float64)
    err, lse_err = float(np.abs(out - ref).max()), float(np.abs(lse - ref_lse).max())
    assert (err <= F32_BAR and lse_err <= 1e-4) == holds, (
        f"{route}: max out error {err:.3g} against {F32_BAR}, lse error {lse_err:.3g} against 1e-4")


# --------------------------------------------------- kernels E and F3
TWO_A = [(1, 0), (0, 0)]  # a_lo b_hi, a_hi b_hi: an f32 A against a bf16 (exact) B


def _f3_emulated(q, k, v, do, bias, lse, delta, passes):
    """Kernel F3 on one tile of keys against every query: S^T = K Q^T and
    dP^T = V dO^T in TF32 passes (width padded to 24, one 32-deep chunk),
    P^T and dS^T in f32 on the fragments, then dV = P^T dO and dK = dS^T Q
    over all the queries, a fresh accumulator every 32 queries promoted
    into the f32 total, and dK scaled at the end."""
    f32 = np.float32
    scale = f32(1.0 / np.sqrt(q.shape[1]))
    qp, kp, vp, dop = (_pad_cols(a, K_STEP) for a in (q, k, v, do))
    st = tc_matmul(kp, np.ascontiguousarray(qp.T), passes)
    st = (st.astype(np.float64) * scale + bias[:, None]).astype(f32)  # one rounding: fmaf
    p = np.exp(st - lse[None, :]).astype(f32)
    dpt = tc_matmul(vp, np.ascontiguousarray(dop.T), passes)
    ds = (p * (dpt - delta[None, :])).astype(f32)
    dv = tc_matmul(p, dop, passes, chunk_depth=CHUNK)
    dk = (tc_matmul(ds, qp, passes, chunk_depth=CHUNK) * scale).astype(f32)
    return dk[:, :q.shape[1]], dv[:, :v.shape[1]], ds.sum(1, dtype=f32)


@pytest.mark.parametrize("route,holds", [("three_tf32_passes", True), ("one_tf32_pass", False)])
def test_flash_dkv_against_float64(route, holds):
    """Kernel F3 at width 20: one 64-key tile against 2,048 queries, whose
    lse and delta come from all 2,048 keys (a quarter masked, bias -1e9);
    dK, dV and dbias within GRAD_REL_F32 of their largest value."""
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.standard_normal((2048, 20)).astype(np.float32) for _ in range(4))
    bias = np.where(rng.random(2048) > 0.25, 0.0, -1e9).astype(np.float32)
    bias[:8] = 0.0
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) / np.sqrt(20) + bias   # (queries, keys)
    lse = s.max(1) + np.log(np.exp(s - s.max(1, keepdims=True)).sum(1))
    p = np.exp(s - lse[:, None])
    delta = ((p @ v.astype(np.float64)) * do).sum(1)
    tile = slice(0, 64)
    got = _f3_emulated(q, k[tile], v[tile], do, bias[tile], lse.astype(np.float32),
                       delta.astype(np.float32), THREE if route == "three_tf32_passes" else ONE)
    pt = p[:, tile].T                                        # (keys, queries)
    dst = pt * (v[tile].astype(np.float64) @ do.T.astype(np.float64) - delta[None, :])
    want = (dst @ q.astype(np.float64) / np.sqrt(20), pt @ do.astype(np.float64), dst.sum(1))
    errs = [float(np.abs(a - b).max()) / float(np.abs(b).max()) for a, b in zip(got, want)]
    assert (max(errs) <= GRAD_REL_F32) == holds, f"{route}: dk, dv, dbias relative errors {errs}"


def _tower_rows(rng, rows=256, d=400):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    lim = np.sqrt(6.0 / (2 * d))  # xavier-uniform, as the tower's Dense kernels
    w = rng.uniform(-lim, lim, (d, 3 * d)).astype(np.float32)  # [Wq | Wk | Wv]
    return x, w


@pytest.mark.parametrize("route,holds", [
    ("f32_three_tf32_passes", True),
    ("bf16_one_tf32_pass", True),
    ("f32_one_tf32_pass", False),
])
def test_user_tower_qkv_product_against_float64(route, holds):
    """Kernel E's recompute x [Wq|Wk|Wv] (K = 400 -> 1,200) over 256 history
    rows, within chip_smoke.py's f32 output bar. Under bf16 x and W are
    exact in TF32 and one pass forms the exact products."""
    x, w = _tower_rows(np.random.default_rng(5))
    if route.startswith("bf16"):
        x, w = to_bf16(x), to_bf16(w)
        assert np.array_equal(tf32_rna(x), x) and np.array_equal(tf32_rna(w), w)
    passes = THREE if route == "f32_three_tf32_passes" else ONE
    # D = 400 is 12.5 chunks: the last one zero-filled to 32 deep
    got = tc_matmul(_pad_cols(x, CHUNK), _pad_cols(w.T, CHUNK).T, passes)
    err = float(np.abs(got - x.astype(np.float64) @ w.astype(np.float64)).max())
    assert (err <= F32_ATOL) == holds, f"{route}: max q|k|v error {err:.3g} against {F32_ATOL}"
    if holds:  # and with room: the kernel adds its own reduction order
        assert err <= F32_ATOL / 10


@pytest.mark.parametrize("route,holds", [
    ("f32_three_tf32_passes", True),
    ("bf16_weights_two_tf32_passes", True),
    ("f32_one_tf32_pass", False),
])
def test_user_tower_dx_product_against_float64(route, holds):
    """Kernel E's dx = [dQ|dK|dV] [Wq|Wk|Wv]^T (K = 1,200 -> 400) over 256
    history rows, within GRAD_REL_F32 of the largest |dx|. The cotangents
    stay f32 under bf16, so they are split against the exact bf16 W."""
    rng = np.random.default_rng(6)
    _, w = _tower_rows(rng)
    dy = (rng.standard_normal((256, 1200)) * 1e-2).astype(np.float32)
    passes = {"f32_three_tf32_passes": THREE, "bf16_weights_two_tf32_passes": TWO_A,
              "f32_one_tf32_pass": ONE}[route]
    if route.startswith("bf16"):
        w = to_bf16(w)
    got = tc_matmul(dy, np.ascontiguousarray(w.T), passes)
    ref = dy.astype(np.float64) @ w.T.astype(np.float64)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert (err <= GRAD_REL_F32 * scale) == holds, (
        f"{route}: max dx error {err:.3g} against {GRAD_REL_F32} x {scale:.3g}")
    if holds:
        assert err <= GRAD_REL_F32 * scale / 10


def _f2_emulated(q, k, v, do, bias, lse, delta, passes):
    """Kernel F2 on one tile of queries against every key: S = Q K^T (one
    32-deep chunk at width 24) and dP = dO V^T (a fresh accumulator every 8
    of depth) in TF32 passes per 64-key tile, P and dS in f32 on the
    fragments, then dQ = dS K over
    all the keys, a fresh accumulator every 32 keys promoted into the f32
    total, and dQ scaled at the end."""
    f32 = np.float32
    scale = f32(1.0 / np.sqrt(q.shape[1]))
    qp, kp, vp, dop = (_pad_cols(a, K_STEP) for a in (q, k, v, do))
    ds = np.zeros((q.shape[0], k.shape[0]), f32)
    for k0 in range(0, k.shape[0], 64):
        s = tc_matmul(qp, np.ascontiguousarray(kp[k0:k0 + 64].T), passes)
        s = (s.astype(np.float64) * scale + bias[k0:k0 + 64]).astype(f32)  # one rounding: fmaf
        p = np.exp(s - lse[:, None]).astype(f32)
        # dP: a fresh accumulator every 8 of depth (it cancels against delta)
        dp = tc_matmul(dop, np.ascontiguousarray(vp[k0:k0 + 64].T), passes, chunk_depth=K_STEP)
        ds[:, k0:k0 + 64] = p * (dp - delta[:, None])
    dq = (tc_matmul(ds, kp, passes, chunk_depth=CHUNK) * scale).astype(f32)
    return dq[:, :q.shape[1]]


@pytest.mark.parametrize("queries", ["first_tile", "last_tile"])
@pytest.mark.parametrize("route,holds", [("three_tf32_passes", True), ("one_tf32_pass", False)])
def test_flash_dq_against_float64(queries, route, holds):
    """Kernel F2 at width 20: a 64-query tile against 2,048 keys (a quarter
    masked, bias -1e9), lse and delta from float64 over all the keys; dQ
    within GRAD_REL_F32 of its largest value."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((2048, 20)).astype(np.float32) for _ in range(4))
    bias = np.where(rng.random(2048) > 0.25, 0.0, -1e9).astype(np.float32)
    bias[:8] = 0.0
    tile = slice(0, 64) if queries == "first_tile" else slice(2048 - 64, 2048)
    s = (q[tile].astype(np.float64) @ k.T.astype(np.float64)) / np.sqrt(20) + bias  # (queries, keys)
    lse = s.max(1) + np.log(np.exp(s - s.max(1, keepdims=True)).sum(1))
    p = np.exp(s - lse[:, None])
    delta = ((p @ v.astype(np.float64)) * do[tile]).sum(1)
    got = _f2_emulated(q[tile], k, v, do[tile], bias, lse.astype(np.float32),
                       delta.astype(np.float32), THREE if route == "three_tf32_passes" else ONE)
    ds = p * (do[tile].astype(np.float64) @ v.T.astype(np.float64) - delta[:, None])
    want = ds @ k.astype(np.float64) / np.sqrt(20)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert (err <= GRAD_REL_F32 * scale) == holds, (
        f"{route}: max dq error {err:.3g} against {GRAD_REL_F32} x {scale:.3g}")
    if holds:  # and with room: the kernel adds its own reduction order
        assert err <= GRAD_REL_F32 * scale / 10


@pytest.mark.parametrize("dp_chunk,holds", [(K_STEP, True), (CHUNK, False)])
def test_flash_dq_of_one_key(dp_chunk, holds):
    """The inputs of tests/test_torch_gpu.py::test_flash_kernels_match_plain
    at one key and width 64: p = 1 and dP = delta, so the true dq is 0 and
    F2's is dP's error times K. With dP in a fresh accumulator every 8 of
    depth it stays inside that test's 1e-6 floor; with 32-deep chunks, as
    S is summed, it does not."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((3, 1, 64)).astype(np.float32) for _ in range(3))
    g = rng.standard_normal((3, 1, 64)).astype(np.float32)
    worst = 0.0
    for b in range(3):
        delta = (g[b] * v[b]).sum(-1, dtype=np.float32)  # out = v: one key
        dp = tc_matmul(g[b], np.ascontiguousarray(v[b].T), THREE, chunk_depth=dp_chunk)
        ds = (dp - delta[:, None]).astype(np.float32)
        dq = tc_matmul(_pad_cols(ds, K_STEP), _pad_cols(k[b].T, K_STEP).T, THREE) / np.float32(8.0)
        worst = max(worst, float(np.abs(dq).max()))
    assert (worst <= 1e-6) == holds, f"dP summed {dp_chunk} deep: |dq| {worst:.3g} against 1e-6"
