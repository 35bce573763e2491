"""The port's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here needs a CUDA device and
skips without one (decided in the ``cuda`` fixture, never at import). On a
GPU machine, where JAX may be absent (``tests/conftest.py`` imports it):
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.

Shapes are small and deliberately ragged (L=7, H=7, D=32..48), so the
kernels' padding of token/history rows to their register tiles and of
hidden units to whole warps is exercised; ``chip_smoke.py`` covers the
full-width shapes. Tolerances: f32 atol 1e-5 + rtol 1e-5 (the same
products summed in another order, reductions <= 768 long over O(1)
values; candidate scores reach O(10)); bf16 in the JAX band atol 0.15 /
rtol 0.05, since a different summation order can flip one bf16 rounding.
Gradients (kernels D, E and kernel A's backward) compare against autograd
of the plain versions, per output relative to its largest value: f32
within 1e-4 of it (weight gradients sum up to a few thousand rows here, in
another order), bf16 within 5% (the plain version's autograd rounds each
gradient through bf16 where the kernels keep f32, as the JAX ones do).
The flash backward kernels (F2, F3) compare against ``flash_backward_plain``,
which rounds at the kernels' points, on the same relative bars.
"""

import contextlib

import numpy as np
import pytest
import torch

from fedrec_tpu_torch.ops import (
    TextHeadWeights,
    UserTowerWeights,
    additive_pool,
    additive_pool_long,
    additive_pool_plain,
    flash_attention,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_plain,
    flash_forward,
    flash_forward_plain,
    fused_gather_encode,
    fused_gather_encode_bwd,
    fused_gather_encode_bwd_plain,
    fused_gather_encode_plain,
    fused_history_score,
    fused_history_score_bwd,
    fused_history_score_bwd_plain,
    fused_history_score_plain,
    launch_counts,
    reset_launch_counts,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


@contextlib.contextmanager
def _one_cpu_thread():
    """Compute a CPU reference on one thread. On the H100 hosts, PyTorch's
    multi-threaded f32 CPU products now and then returned one batch slice of
    a batched product ~4e-5 off (1 of 36 whole runs of this file: against a
    float64 reference the card's output was within 1.1e-6 on every slice,
    the 8-thread CPU reference 4.0e-5 off on one, a recompute of it
    differed, and a one-thread recompute was within 5.1e-7)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 7, 48, 24), (3, 50, 768, 384), (2, 33, 64, 40)])
@pytest.mark.parametrize("kind", ["none", "partial", "fully_masked_row"])
def test_additive_pool_kernel_matches_plain(cuda, rng, dtype, shape, kind):
    n, L, D, hd = shape
    x = _t(rng.standard_normal((n, L, D)), cuda, dtype)
    w1 = _t(rng.standard_normal((D, hd)) / np.sqrt(D), cuda)
    b1 = _t(rng.standard_normal(hd) * 0.05, cuda)
    w2 = _t(rng.standard_normal(hd) / np.sqrt(hd), cuda)
    mask = None
    if kind != "none":
        m = (rng.random((n, L)) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        if kind == "fully_masked_row":
            m[1] = 0.0
        mask = _t(m, cuda)
    reset_launch_counts()
    got = additive_pool(x, w1, b1, w2, mask)
    torch.cuda.synchronize()
    assert launch_counts()["additive_pool"] == 1
    assert got.dtype == dtype and got.shape == (n, D)
    _close(got, additive_pool_plain(x, w1, b1, w2, mask), dtype)
    if kind == "fully_masked_row":
        assert bool((got[1] == 0).all())


# (n, L, D, Hd): the edges of kernel A's logits pass (64-row tiles, 32-deep
# chunks, 32 NT-unit hidden tiles) and of its pool pass (column blocks)
_POOL_EDGES = {
    "rows_not_a_tile_multiple": (3, 50, 768, 384),  # R = 150
    "one_token": (70, 1, 768, 384),                 # L = 1
    "hidden_200_width_400": (5, 50, 400, 200),      # one 224-wide tile, a 16-deep tail chunk
    "hidden_not_a_multiple_of_4": (4, 9, 48, 29),   # W1 copied an element at a time
    "width_over_1024": (2, 5, 1100, 64),            # two column blocks, a 12-deep tail chunk
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_POOL_EDGES))
@pytest.mark.parametrize("kind", ["none", "partial", "fully_masked_row"])
def test_additive_pool_tile_edges(cuda, rng, dtype, case, kind):
    """Kernel A where its tiles end ragged, against the plain version at the
    bars above; a fully-masked row pools to exactly 0."""
    test_additive_pool_kernel_matches_plain(cuda, rng, dtype, _POOL_EDGES[case], kind)


def test_pool_and_flash_forward_repeat_to_the_bit(cuda, rng):
    """Kernels A (f32 and bf16), A2 and F1 give the same bits twice."""
    x = _t(rng.standard_normal((9, 50, 768)), cuda)
    w1 = _t(rng.standard_normal((768, 384)) / np.sqrt(768), cuda)
    b1, w2 = _t(rng.standard_normal(384) * 0.05, cuda), _t(rng.standard_normal(384) / 20, cuda)
    m = (rng.random((9, 50)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    mask = _t(m, cuda)
    for xx in (x, x.bfloat16()):
        assert torch.equal(additive_pool(xx, w1, b1, w2, mask), additive_pool(xx, w1, b1, w2, mask))
    xl = _t(rng.standard_normal((3, 2048, 400)), cuda)
    w1l = _t(rng.standard_normal((400, 200)) / 20, cuda)
    b1l, w2l = _t(rng.standard_normal(200) * 0.05, cuda), _t(rng.standard_normal(200) / 14, cuda)
    assert torch.equal(additive_pool_long(xl, w1l, b1l, w2l), additive_pool_long(xl, w1l, b1l, w2l))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, _ = _flash_inputs(rng, cuda, dtype, 6, 333, 20, "partial")
        a, b = flash_forward(q, k, v, bias), flash_forward(q, k, v, bias)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _tower(rng, d, q, dev, dtype):
    """Weights scaled by 1/sqrt(fan-in), so activations stay O(1) at any width."""
    def r(*s, scale=None):
        scale = 1.0 / np.sqrt(s[0]) if scale is None else scale
        return _t(rng.standard_normal(s) * scale, dev, dtype)

    return UserTowerWeights(
        r(d, d), r(d, scale=0.05), r(d, d), r(d, scale=0.05), r(d, d), r(d, scale=0.05),
        r(d, q), r(q, scale=0.05), r(q),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 7, 32, 4, 16), (3, 50, 400, 20, 200), (2, 13, 40, 5, 24)])
@pytest.mark.parametrize("c", [0, 5])
def test_fused_history_score_kernel_matches_plain(cuda, rng, dtype, shape, c):
    b, h, d, nh, q = shape
    x = _t(rng.standard_normal((b, h, d)), cuda, dtype)
    cand = _t(rng.standard_normal((b, c, d)), cuda, dtype) if c else None
    m = (rng.random((b, h)) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    m[1] = 0.0  # a fully-masked history pools to ~0
    mask = _t(m, cuda)
    w = _tower(rng, d, q, cuda, dtype)
    reset_launch_counts()
    sk, uk = fused_history_score(x, cand, mask, w, nh)
    torch.cuda.synchronize()
    assert launch_counts()["fused_history_score"] == 1
    sp, up = fused_history_score_plain(x, cand, mask, w, nh)
    _close(uk, up, dtype)
    if c:
        _close(sk, sp, dtype)
    else:
        assert sk is None
    assert float(uk[1].float().abs().max()) < 1e-5


# (n, H, D, heads, Q, C, fully-masked row or None): the edges of kernel B's
# row products (64-row tiles over the flat n H rows), per-head and per-row
# blocks
_HIST_FWD_EDGES = {
    "one_row": (1, 50, 400, 20, 200, 0, None),
    "rows_not_a_tile_multiple": (3, 13, 40, 5, 24, 5, None),   # n H = 39
    "serving_bucket_128": (128, 50, 400, 20, 200, 0, None),
    "train_path": (64, 50, 400, 20, 200, 5, None),
    "fully_masked_row": (4, 50, 400, 20, 200, 5, 2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_HIST_FWD_EDGES))
def test_fused_history_score_tiling_edges(cuda, rng, dtype, case):
    """Kernel B where its launches end ragged, against the plain version at
    the bars above; a fully-masked row's user vector is ~0."""
    b, h, d, nh, q, c, dead = _HIST_FWD_EDGES[case]
    x = _t(rng.standard_normal((b, h, d)), cuda, dtype)
    cand = _t(rng.standard_normal((b, c, d)), cuda, dtype) if c else None
    m = (rng.random((b, h)) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    if dead is not None:
        m[dead] = 0.0
    mask = _t(m, cuda)
    w = _tower(rng, d, q, cuda, dtype)
    reset_launch_counts()
    sk, uk = fused_history_score(x, cand, mask, w, nh)
    torch.cuda.synchronize()
    assert launch_counts()["fused_history_score"] == 1
    assert uk.dtype == dtype and uk.shape == (b, d)
    sp, up = fused_history_score_plain(x, cand, mask, w, nh)
    _close(uk, up, dtype)
    if c:
        assert sk.dtype == dtype and sk.shape == (b, c)
        _close(sk, sp, dtype)
    else:
        assert sk is None
    if dead is not None:
        assert float(uk[dead].float().abs().max()) < 1e-5


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda, rng):
    x = torch.randn((2, 7, 48), device=cuda)
    w1, b1, w2 = torch.randn((48, 24), device=cuda), torch.zeros(24, device=cuda), torch.randn(24, device=cuda)
    with pytest.raises(TypeError):
        additive_pool(x.half(), w1, b1, w2)
    with pytest.raises(ValueError):
        additive_pool(x, w1.cpu(), b1, w2)
    with pytest.raises(ValueError):
        additive_pool(torch.randn((2, 7, 50), device=cuda), torch.randn((50, 24), device=cuda), b1, w2)
    w = _tower(rng, 32, 16, cuda, torch.float32)
    with pytest.raises(ValueError):
        fused_history_score(torch.randn((2, 7, 32), device=cuda), None, None, w, 3)
    with pytest.raises(ValueError):
        fused_history_score(torch.randn((2, 7, 32), device=cuda), None,
                            torch.ones((2, 6), device=cuda), w, 4)


def _close_grad(got, want, dtype, what="", floor=1e-6):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = float(np.abs(want).max()) if want.size else 0.0
    rel = 1e-4 if dtype == torch.float32 else 0.05
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + floor, f"{what}: max err {err} against {rel} x {scale} + {floor}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_additive_pool_backward_matches_plain_autograd(cuda, rng, dtype):
    n, L, D, hd = 5, 33, 64, 40
    x = _t(rng.standard_normal((n, L, D)), cuda, dtype)
    w = [_t(rng.standard_normal(s) / np.sqrt(s[0]), cuda) for s in [(D, hd), (hd,), (hd,)]]
    m = (rng.random((n, L)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    mask = _t(m, cuda)
    g = _t(rng.standard_normal((n, D)), cuda, dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, *w)]
        return torch.autograd.grad(fn(*leaves, mask), leaves, g)

    reset_launch_counts()
    got = grads(additive_pool)
    assert launch_counts()["additive_pool"] == 1
    for name, a, b in zip(("x", "w1", "b1", "w2"), got, grads(additive_pool_plain)):
        _close_grad(a, b, dtype, name)


def _head(rng, dh, ah, d, dev, dtype):
    def r(*s, scale=None):
        scale = 1.0 / np.sqrt(s[0]) if scale is None else scale
        return _t(rng.standard_normal(s) * scale, dev, dtype)

    return TextHeadWeights(r(dh, ah), r(ah, scale=0.05), r(ah), r(dh, d), r(d, scale=0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(9, 7, 48, 24, 20, 6), (40, 50, 768, 384, 400, 17), (12, 33, 64, 40, 24, 11)])
def test_fused_gather_encode_kernels_match_plain(cuda, rng, dtype, shape):
    n, t, dh, ah, d, u = shape
    table = _t(rng.standard_normal((n, t, dh)), cuda, dtype)
    ids = torch.from_numpy(rng.integers(0, n, u)).to(cuda)
    ids[-2:] = 0  # padded slots, as the static-size unique pads with id 0
    w = _head(rng, dh, ah, d, cuda, dtype)
    reset_launch_counts()
    out = fused_gather_encode(table, ids, w)
    torch.cuda.synchronize()
    assert launch_counts()["fused_gather_encode"] == 1 and out.dtype == dtype
    _close(out, fused_gather_encode_plain(table, ids, w), dtype)
    g = _t(rng.standard_normal((u, d)), cuda)
    g[-1] = 0.0  # a padded slot gets no cotangent
    got = fused_gather_encode_bwd(table, ids, w, g)
    torch.cuda.synchronize()
    assert launch_counts()["fused_gather_encode_bwd"] == 1
    for name, a, b in zip(TextHeadWeights._fields, got, fused_gather_encode_bwd_plain(table, ids, w, g)):
        assert a.dtype == dtype
        _close_grad(a, b, dtype, name)
    # through autograd: kernel C forward, kernel D backward, nothing for the table
    # (autograd hands the backward a cotangent in the output's dtype)
    leaves = [t_.clone().requires_grad_() for t_ in w]
    auto = torch.autograd.grad(fused_gather_encode(table, ids, TextHeadWeights(*leaves)), leaves, g.to(dtype))
    for a, b in zip(auto, fused_gather_encode_bwd(table, ids, w, g.to(dtype))):
        assert torch.equal(a, b)
    assert launch_counts()["fused_gather_encode_bwd"] == 3


def _check_history_score_backward(dev, rng, dtype, b, h, d, nh, q, c, dead):
    """Kernel E against autograd of the plain version on random inputs, a
    quarter of the clicks masked and history row ``dead`` (if any) fully."""
    x = _t(rng.standard_normal((b, h, d)), dev, dtype)
    cand = _t(rng.standard_normal((b, c, d)), dev, dtype) if c else None
    m = (rng.random((b, h)) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    if dead is not None:
        m[dead] = 0.0
    mask = _t(m, dev)
    w = _tower(rng, d, q, dev, dtype)
    gs = _t(rng.standard_normal((b, c)), dev) if c else None
    gu = _t(rng.standard_normal((b, d)), dev)
    reset_launch_counts()
    dx, dcand, dw = fused_history_score_bwd(x, cand, mask, w, gs, gu, nh)
    torch.cuda.synchronize()
    assert launch_counts()["fused_history_score_bwd"] == 1
    px, pc, pw = fused_history_score_bwd_plain(x, cand, mask, w, gs, gu, nh)
    _close_grad(dx, px, dtype, "dx")
    if c:
        _close_grad(dcand, pc, dtype, "dcand")
    else:
        assert dcand is None
    if dead is not None:  # a fully-masked row pools to ~0: no gradient reaches its history
        assert float(dx[dead].float().abs().max()) <= 1e-6
    for name, a, b_ in zip(UserTowerWeights._fields, dw, pw):
        if name == "bk":  # its true gradient is zero: both sides are float noise
            assert float(a.float().abs().max()) <= 1e-3 * max(1.0, float(b_.float().abs().max()))
            continue
        _close_grad(a, b_, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 7, 32, 4, 16), (3, 50, 400, 20, 200), (2, 13, 40, 5, 24)])
@pytest.mark.parametrize("c", [0, 5])
def test_fused_history_score_backward_matches_plain(cuda, rng, dtype, shape, c):
    _check_history_score_backward(cuda, rng, dtype, *shape, c, dead=1)


def _tower_grads_f64(x, cand, mask, w, gs, gu, nh):
    """Autograd of the user tower (``fused_history_score_plain``'s
    arithmetic without its rounding points) in float64 on the CPU: the exact
    answer kernel E and the plain f32 route are both held to."""
    from fedrec_tpu_torch.ops.fused_hot_path import masked_softmax

    with torch.enable_grad():
        xl, cl = (t.detach().cpu().double().requires_grad_() for t in (x, cand))
        wl = UserTowerWeights(*(t.detach().cpu().double().requires_grad_() for t in w))
        m = mask.cpu().double()
        n, h, d = xl.shape
        q, k, v = (xl @ a + b for a, b in ((wl.wq, wl.bq), (wl.wk, wl.bk), (wl.wv, wl.bv)))

        def heads(t):
            return t.reshape(n, h, nh, d // nh).transpose(1, 2)

        a = masked_softmax(heads(q) @ heads(k).transpose(-1, -2) / np.sqrt(d // nh),
                           m[:, None, None, :])
        ctx = (a @ heads(v)).transpose(1, 2).reshape(n, h, d)
        alpha = masked_softmax(torch.tanh(ctx @ wl.pw1 + wl.pb1) @ wl.pw2, m)
        user = torch.einsum("nh,nhd->nd", alpha, ctx)
        scores = torch.einsum("ncd,nd->nc", cl, user)
        return torch.autograd.grad([user, scores], [xl, cl, *wl],
                                   [gu.cpu().double(), gs.cpu().double()])


@pytest.mark.parametrize("common", [0.0, 1.0])
def test_fused_history_score_backward_keeps_cancelling_gradients(cuda, rng, common):
    """Histories and candidates that share a large common part (as the CNN
    head's news vectors do) flatten both softmaxes, so the pool's weight
    gradients and the key bias's cancel to far below their terms. Every
    output of kernel E against float64: within 10 x the plain f32 route's
    own error, or 1e-4 of the output's scale, whichever is larger (a kernel
    that returned zeros for a cancelling output would miss it)."""
    n, h, d, nh, q, c = 8, 50, 400, 20, 200, 5
    base = np.abs(rng.standard_normal(d)) * common
    x = _t(base + 0.05 * rng.standard_normal((n, h, d)), cuda)
    cand = _t(base + 0.05 * rng.standard_normal((n, c, d)), cuda)
    m = (rng.random((n, h)) > 0.25).astype(np.float32)
    m[:, 0] = 1.0
    mask = _t(m, cuda)
    w = _tower(rng, d, q, cuda, torch.float32)
    gs, gu = _t(rng.standard_normal((n, c)), cuda), _t(rng.standard_normal((n, d)), cuda)
    dx, dcand, dw = fused_history_score_bwd(x, cand, mask, w, gs, gu, nh)
    px, pc, pw = fused_history_score_bwd_plain(x, cand, mask, w, gs, gu, nh)
    ref = _tower_grads_f64(x, cand, mask, w, gs, gu, nh)
    names = ["x", "cand", *UserTowerWeights._fields]
    for name, a, b, r in zip(names, [dx, dcand, *dw], [px, pc, *pw], ref):
        err_k, err_p = (float((t.detach().cpu().double() - r).abs().max()) for t in (a, b))
        bar = max(10 * err_p, 1e-4 * float(r.abs().max()))
        assert err_k <= bar, f"{name}: kernel {err_k} vs float64, plain {err_p}, bar {bar}"


@pytest.mark.parametrize("common", [0.0, 1.0])
def test_fused_gather_encode_backward_keeps_cancelling_gradients(cuda, rng, common):
    """Kernel D on token rows that share a large common part: every head
    gradient against float64 at the bar of the test above."""
    from fedrec_tpu_torch.ops.fused_hot_path import masked_softmax

    n, t, dh, ah, d, u = 24, 50, 768, 384, 400, 17
    base = np.abs(rng.standard_normal(dh)) * common
    table = _t(base + 0.05 * rng.standard_normal((n, t, dh)), cuda)
    ids = torch.from_numpy(rng.integers(0, n, u)).to(cuda)
    w = _head(rng, dh, ah, d, cuda, torch.float32)
    g = _t(rng.standard_normal((u, d)), cuda)
    got = fused_gather_encode_bwd(table, ids, w, g)
    plain = fused_gather_encode_bwd_plain(table, ids, w, g)
    with torch.enable_grad():
        wl = TextHeadWeights(*(p.detach().cpu().double().requires_grad_() for p in w))
        xs = table.cpu().double()[ids.cpu()]
        lg = torch.tanh(xs @ wl.w1 + wl.b1) @ wl.w2
        pooled = torch.einsum("ut,utd->ud", masked_softmax(lg, torch.ones_like(lg)), xs)
        ref = torch.autograd.grad(pooled @ wl.fcw + wl.fcb, list(wl), g.cpu().double())
    for name, a, b, r in zip(TextHeadWeights._fields, got, plain, ref):
        err_k, err_p = (float((x.cpu().double() - r).abs().max()) for x in (a, b))
        bar = max(10 * err_p, 1e-4 * float(r.abs().max()))
        assert err_k <= bar, f"{name}: kernel {err_k} vs float64, plain {err_p}, bar {bar}"


def _flash_grads_f64(q, k, v, bias, g):
    """(dq, dk, dv, dbias) of softmax(q k^T / sqrt(d) + bias) v against the
    cotangent ``g``, by float64 autograd on the CPU."""
    with torch.enable_grad():
        leaves = [t.detach().cpu().double().requires_grad_() for t in (q, k, v, bias)]
        ql, kl, vl, bl = leaves
        s = ql @ kl.transpose(-1, -2) / np.sqrt(q.shape[-1]) + bl[:, None, :]
        out = torch.softmax(s, -1) @ vl
        return torch.autograd.grad(out, leaves, g.detach().cpu().double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [130, 600])
@pytest.mark.parametrize("common", [0.0, 1.0])
def test_flash_backward_keeps_cancelling_gradients(cuda, rng, dtype, L, common):
    """Keys that share a large common part (a common vector plus small
    per-key noise) flatten the softmax, so each dS row sums to ~0 and dq's
    common term cancels to far below its parts. F1's forward, then F2 (dq)
    and F3 (dk, dv, dbias), every output against float64: within 10 x the
    plain route's own error, or 1e-4 of the output's scale, whichever is
    larger (kernel E's bar)."""
    bh, d = 4, 20
    base = np.abs(rng.standard_normal(d)) * common
    q = _t(rng.standard_normal((bh, L, d)), cuda, dtype)
    k = _t(base + 0.05 * rng.standard_normal((bh, L, d)), cuda, dtype)
    v = _t(rng.standard_normal((bh, L, d)), cuda, dtype)
    keep = rng.random((bh, L)) > 0.3
    keep[:, 0] = True
    bias = _t(np.where(keep, 0.0, -1e9), cuda)
    g = _t(rng.standard_normal((bh, L, d)), cuda, dtype)
    out, lse = flash_forward(q, k, v, bias)
    delta = (g.float() * out.float()).sum(-1)
    got = (flash_backward_dq(q, k, v, bias, g, lse, delta),
           *flash_backward_dkv(q, k, v, bias, g, lse, delta))
    torch.cuda.synchronize()
    with _one_cpu_thread():
        cpu = [t.cpu() for t in (q, k, v, bias, g)]
        p_out, p_lse = flash_forward_plain(*cpu[:4])
        plain = flash_backward_plain(*cpu[:4], p_out, p_lse, cpu[4])
        ref = _flash_grads_f64(*cpu)
    for name, a, b, r in zip(("dq", "dk", "dv", "dbias"), got, plain, ref):
        err_k, err_p = (float((t.detach().cpu().double() - r).abs().max()) for t in (a, b))
        bar = max(10 * err_p, 1e-4 * float(r.abs().max()))
        assert err_k <= bar, f"{name}: kernel {err_k} vs float64, plain {err_p}, bar {bar}"


# (n, H, D, heads, Q, C, fully-masked row or None): the edges of kernel E's
# row products (64-row tiles over the flat n H rows) and per-head blocks
_HIST_BWD_EDGES = {
    "one_row": (1, 50, 400, 20, 200, 5, None),
    "rows_not_a_tile_multiple": (3, 13, 40, 5, 24, 5, None),   # n H = 39
    "train_path": (64, 50, 400, 20, 200, 5, None),
    "no_candidates": (4, 50, 400, 20, 200, 0, None),
    "fully_masked_row": (4, 50, 400, 20, 200, 5, 2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_HIST_BWD_EDGES))
def test_fused_history_score_backward_tiling_edges(cuda, rng, dtype, case):
    b, h, d, nh, q, c, dead = _HIST_BWD_EDGES[case]
    _check_history_score_backward(cuda, rng, dtype, b, h, d, nh, q, c, dead)


# (table rows, T, Dh, Ah, D, ids): the row tiling's edges of kernels C and D
_GATHER_EDGES = {
    "one_id": (5, 50, 768, 384, 400, [3]),
    "rows_not_a_tile_multiple": (8, 50, 768, 384, 400, [1, 6, 2]),   # R = 150
    "ids_at_the_clamp_edges": (6, 7, 48, 24, 20, [-1, 6, 2, 5, 0]),
    "all_padded": (6, 33, 64, 40, 24, [0, 0, 0, 0]),
    "full_width": (64, 50, 768, 384, 400, "random_300"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_GATHER_EDGES))
def test_fused_gather_encode_row_tiling_edges(cuda, rng, dtype, case):
    """One id, R = U T not a multiple of the 64-row tile, ids out of range
    (clamped into the table, as JAX's gather clamps), every slot padded with
    g = 0, and the full width at U = 300: kernels C and D against the plain
    versions (given the clamped ids) at the bars above."""
    n, t, dh, ah, d, ids = _GATHER_EDGES[case]
    table = _t(rng.standard_normal((n, t, dh)), cuda, dtype)
    if ids == "random_300":
        ids = rng.integers(0, n, 300).tolist()
    ids = torch.tensor(ids, dtype=torch.int64, device=cuda)
    w = _head(rng, dh, ah, d, cuda, dtype)
    g = _t(rng.standard_normal((ids.numel(), d)), cuda)
    if case == "all_padded":
        g.zero_()
    reset_launch_counts()
    out = fused_gather_encode(table, ids, w)
    got = fused_gather_encode_bwd(table, ids, w, g)
    torch.cuda.synchronize()
    assert launch_counts()["fused_gather_encode"] == 1
    assert launch_counts()["fused_gather_encode_bwd"] == 1
    clamped = ids.clamp(0, n - 1)
    _close(out, fused_gather_encode_plain(table, clamped, w), dtype)
    want = fused_gather_encode_bwd_plain(table, clamped, w, g)
    for name, a, b in zip(TextHeadWeights._fields, got, want):
        _close_grad(a, b, dtype, name)
        if case == "all_padded":
            assert not bool(a.any()), f"{name}: g = 0 must add exactly zero"


def test_tf32_split_rounding_is_cvt_rna(cuda, rng):
    """Kernels C and D round f32 to TF32 with two integer ops; on the card
    they must give the bits of cvt.rna.tf32.f32 itself, ties included."""
    from fedrec_tpu_torch.ops import fused_hot_path as fh

    bits = rng.integers(0x00800000, 0x7F000000, 1 << 16, dtype=np.uint32)  # finite normals
    bits[::4] = (bits[::4] & np.uint32(0xFFFFE000)) | np.uint32(0x1000)      # exact ties
    bits[1::2] |= np.uint32(0x80000000)                                     # and negatives
    x = torch.from_numpy(bits.view(np.float32)).to(cuda)
    by_ops, by_cvt = (torch.empty(x.shape, dtype=torch.int32, device=cuda) for _ in range(2))
    err = fh._gather_lib().fused_gather_encode_tf32_check(
        x.data_ptr(), by_ops.data_ptr(), by_cvt.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(by_ops, by_cvt)


def test_backward_kernels_are_deterministic(cuda, rng):
    table = _t(rng.standard_normal((30, 50, 768)), cuda)
    ids = torch.from_numpy(rng.integers(0, 30, 64)).to(cuda)
    w = _head(rng, 768, 384, 400, cuda, torch.float32)
    g = _t(rng.standard_normal((64, 400)), cuda)
    a = fused_gather_encode_bwd(table, ids, w, g)
    b = fused_gather_encode_bwd(table, ids, w, g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x = _t(rng.standard_normal((8, 50, 400)), cuda)
    tw = _tower(rng, 400, 200, cuda, torch.float32)
    gu = _t(rng.standard_normal((8, 400)), cuda)
    a = fused_history_score_bwd(x, None, None, tw, None, gu, 20)
    b = fused_history_score_bwd(x, None, None, tw, None, gu, 20)
    assert torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[2], b[2]))
    # and kernel B, the forward E recomputes
    cand = _t(rng.standard_normal((8, 5, 400)), cuda)
    a = fused_history_score(x, cand, None, tw, 20)
    b = fused_history_score(x, cand, None, tw, 20)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------- long-history kernels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 2048, 400, 200), (3, 126, 400, 200)])
@pytest.mark.parametrize("kind", ["none", "partial", "fully_masked_row"])
def test_additive_pool_long_rows_take_kernel_a2(cuda, rng, dtype, shape, kind):
    """Rows too long for kernel A's shared memory (126 tokens of 400 and
    up) pool through kernel A2, picked before the launch."""
    n, L, D, hd = shape
    x = _t(rng.standard_normal((n, L, D)), cuda, dtype)
    w1 = _t(rng.standard_normal((D, hd)) / np.sqrt(D), cuda)
    b1 = _t(rng.standard_normal(hd) * 0.05, cuda)
    w2 = _t(rng.standard_normal(hd) / np.sqrt(hd), cuda)
    mask = None
    if kind != "none":
        m = (rng.random((n, L)) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        if kind == "fully_masked_row":
            m[1] = 0.0
        mask = _t(m, cuda)
    reset_launch_counts()
    got = additive_pool(x, w1, b1, w2, mask)
    torch.cuda.synchronize()
    assert launch_counts()["additive_pool_long"] == 1 and launch_counts()["additive_pool"] == 0
    assert got.dtype == dtype and got.shape == (n, D)
    _close(got, additive_pool_plain(x, w1, b1, w2, mask), dtype)
    if kind == "fully_masked_row":
        assert bool((got[1] == 0).all())


def test_additive_pool_a2_equals_a_where_both_fit(cuda, rng):
    x = _t(rng.standard_normal((4, 50, 768)), cuda)
    w1 = _t(rng.standard_normal((768, 384)) / np.sqrt(768), cuda)
    b1, w2 = _t(rng.standard_normal(384) * 0.05, cuda), _t(rng.standard_normal(384) / 20, cuda)
    assert torch.equal(additive_pool(x, w1, b1, w2), additive_pool_long(x, w1, b1, w2))


def _flash_inputs(rng, dev, dtype, bh, L, d, kind):
    q, k, v = (_t(rng.standard_normal((bh, L, d)), dev, dtype) for _ in range(3))
    keep = np.ones((bh, L), bool) if kind == "none" else rng.random((bh, L)) > 0.3
    keep[:, 0] = True
    if kind == "fully_masked_row" and bh > 1:
        keep[1] = False
    bias = _t(np.where(keep, 0.0, -1e9), dev)
    g = _t(rng.standard_normal((bh, L, d)), dev, dtype)
    g[~torch.from_numpy(keep.any(1)).to(dev)] = 0  # the wrapper zeroes such rows
    return q, k, v, bias, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 37, 130, 2048])
@pytest.mark.parametrize("d", [8, 20, 64])
@pytest.mark.parametrize("kind", ["none", "partial", "fully_masked_row"])
def test_flash_kernels_match_plain(cuda, rng, dtype, L, d, kind):
    bh = 3 if L < 2048 else 2
    q, k, v, bias, g = _flash_inputs(rng, cuda, dtype, bh, L, d, kind)
    reset_launch_counts()
    out, lse = flash_forward(q, k, v, bias)
    want_out, want_lse = flash_forward_plain(q, k, v, bias)
    delta = (g.float() * want_out.float()).sum(-1)
    dq = flash_backward_dq(q, k, v, bias, g, want_lse, delta)
    dk, dv, dbias = flash_backward_dkv(q, k, v, bias, g, want_lse, delta)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_forward"] == counts["flash_backward_dq"] == counts["flash_backward_dkv"] == 1
    assert out.dtype == dtype and lse.dtype == torch.float32 and dbias.dtype == torch.float32
    _close(out, want_out, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-6)
    want = flash_backward_plain(q, k, v, bias, want_out, want_lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close_grad(a, b, dtype, name)
    # dbias sums p * (dp - delta): where it is ~0 (one key: dp == delta)
    # both sides hold the cancellation's noise, a few f32 ulps of |delta|
    _close_grad(dbias, want[3], torch.float32, "dbias",
                floor=1e-6 * (1.0 + float(delta.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(20, 8), (8, 64), (33, 17), (128, 20)])
def test_flash_kernels_with_unequal_widths(cuda, rng, dtype, dk, dv):
    """dk != dv (and widths that are not multiples of 4, staged without
    cp.async): F1, F2 and F3 against the plain versions at the bars above."""
    bh, L = 3, 130
    q, k, _, bias, _ = _flash_inputs(rng, cuda, dtype, bh, L, dk, "partial")
    v = _t(rng.standard_normal((bh, L, dv)), cuda, dtype)
    g = _t(rng.standard_normal((bh, L, dv)), cuda, dtype)
    out, lse = flash_forward(q, k, v, bias)
    want_out, want_lse = flash_forward_plain(q, k, v, bias)
    torch.cuda.synchronize()
    _close(out, want_out, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-6)
    delta = (g.float() * want_out.float()).sum(-1)
    got = (flash_backward_dq(q, k, v, bias, g, want_lse, delta),
           *flash_backward_dkv(q, k, v, bias, g, want_lse, delta))
    want = flash_backward_plain(q, k, v, bias, want_out, want_lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_grad(a, b, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_module_layout_and_gradients(cuda, rng, dtype):
    """``flash_attention`` in the (B, L, H, d) layout with a key mask:
    kernel F1 forward, F2 and F3 backward, against the CPU plain route."""
    B, L, h, d = 2, 77, 4, 20
    x = [rng.standard_normal((B, L, h, d)) for _ in range(3)]
    m = (rng.random((B, L)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    g = rng.standard_normal((B, L, h, d))
    reset_launch_counts()
    leaves = [_t(a, cuda, dtype).requires_grad_() for a in x]
    out = flash_attention(*leaves, _t(m, cuda))
    grads = torch.autograd.grad(out, leaves, _t(g, cuda, dtype))
    counts = launch_counts()
    assert counts["flash_forward"] == counts["flash_backward_dq"] == counts["flash_backward_dkv"] == 1
    cpu = [_t(a, "cpu", dtype).requires_grad_() for a in x]
    with _one_cpu_thread():
        ref = flash_attention(*cpu, _t(m, "cpu"))
        ref_grads = torch.autograd.grad(ref, cpu, _t(g, "cpu", dtype))
    _close(out.detach(), ref.detach(), dtype)
    for name, a, b in zip("qkv", grads, ref_grads):
        _close_grad(a, b, dtype, "d" + name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [65, 2049])
def test_flash_backward_one_query_past_a_tile(cuda, rng, dtype, L):
    """One query and one key past a whole 64-row tile: F3's last query tile
    and last key block hold a single row each."""
    q, k, v, bias, g = _flash_inputs(rng, cuda, dtype, 2, L, 20, "partial")
    want_out, want_lse = flash_forward_plain(q, k, v, bias)
    delta = (g.float() * want_out.float()).sum(-1)
    reset_launch_counts()
    dk, dv, dbias = flash_backward_dkv(q, k, v, bias, g, want_lse, delta)
    dq = flash_backward_dq(q, k, v, bias, g, want_lse, delta)
    torch.cuda.synchronize()
    assert launch_counts()["flash_backward_dkv"] == 1
    want = flash_backward_plain(q, k, v, bias, want_out, want_lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close_grad(a, b, dtype, name)
    _close_grad(dbias, want[3], torch.float32, "dbias",
                floor=1e-6 * (1.0 + float(delta.abs().max())))


def test_flash_backward_kernels_are_deterministic(cuda, rng):
    q, k, v, bias, g = _flash_inputs(rng, cuda, torch.float32, 40, 2048, 20, "partial")
    out, lse = flash_forward(q, k, v, bias)
    delta = (g * out).sum(-1)
    a = (flash_backward_dq(q, k, v, bias, g, lse, delta), *flash_backward_dkv(q, k, v, bias, g, lse, delta))
    b = (flash_backward_dq(q, k, v, bias, g, lse, delta), *flash_backward_dkv(q, k, v, bias, g, lse, delta))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(flash_forward(q, k, v, bias)[0], out)


def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(cuda, rng):
    bias = torch.zeros((2, 9), device=cuda)
    x = torch.randn((2, 9, 20), device=cuda)
    with pytest.raises(ValueError, match="128"):
        wide = torch.randn((2, 9, 129), device=cuda)
        flash_forward(wide, wide, wide, bias)
    with pytest.raises(TypeError):
        flash_forward(x.half(), x.half(), x.half(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        flash_forward(x, x.transpose(0, 1).contiguous().transpose(0, 1), x, bias)
    with pytest.raises(ValueError, match="contiguous"):
        flash_forward(x, x.bfloat16(), x, bias)
    with pytest.raises(ValueError, match="contiguous"):
        flash_forward(x, x, x, bias.double())
    out, lse = flash_forward(x, x, x, bias)
    with pytest.raises(ValueError, match="delta"):
        flash_backward_dq(x, x, x, bias, x, lse, lse[:, :4])


def test_take_rows_backward_is_deterministic_on_the_card(cuda, rng):
    from fedrec_tpu_torch.train.step import take_rows_backward, unique_padded

    ids = torch.from_numpy(np.concatenate([rng.integers(1, 5000, 30000), np.zeros(8000, np.int64)]))
    _, inv = unique_padded(ids.to(cuda), 4000)  # more distinct ids than slots: clamped
    g = _t(rng.standard_normal((inv.numel(), 400)), cuda)
    got = take_rows_backward(g, inv, 4096)
    assert torch.equal(got, take_rows_backward(g, inv, 4096))
    want = torch.zeros((4096, 400), dtype=torch.float64, device=cuda).index_add_(0, inv, g.double())
    # an f32 sum of n unit-scale terms drifts by about sqrt(n) ulps; a wrong
    # or missing term moves a row by O(1)
    lengths = torch.bincount(inv, minlength=4096).double()[:, None]
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * (1 + lengths)).all()), float(err.max())


def test_quality_stats_repeat_to_the_bit_on_the_card(cuda, rng):
    """The eval step's quality sums (one-hot products summed over rows, no
    atomics) give the same bits every call on the card, and the CPU's
    counts."""
    from fedrec_tpu_torch.eval import QUALITY_SUM_KEYS, quality_stats_batch

    b, p = 256, 40
    pos, neg = rng.standard_normal(b) * 3, rng.standard_normal((b, p)) * 3
    lens = rng.integers(0, p + 1, b)
    mask = (np.arange(p)[None, :] < lens[:, None]).astype(np.float32)
    keep = (np.arange(b) < b - 7).astype(np.float32)
    args = [_t(a, cuda) for a in (pos, neg, mask, keep)]
    first = quality_stats_batch(*args, 20, 5.0, 10)
    again = quality_stats_batch(*args, 20, 5.0, 10)
    cpu = quality_stats_batch(*[a.cpu() for a in args], 20, 5.0, 10)
    for k in QUALITY_SUM_KEYS:
        assert torch.equal(first[k], again[k]), k
        np.testing.assert_allclose(first[k].cpu().numpy(), cpu[k].numpy(), rtol=1e-6, atol=1e-4,
                                   err_msg=k)


def test_trainer_on_the_card_matches_the_cpu_and_resumes_bitwise(cuda, tmp_path):
    """A small evaluated run on the kernel route: kernels A-E launch, the
    round losses match the CPU's plain route at the trajectory bars (dropout
    0: the card's generators draw other masks than the CPU's), and with
    dropout on a 2-round run resumed to 3 equals a straight 3-round run to
    the bit."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.train import Trainer

    def cfg(rounds, where, dropout):
        return ExperimentConfig().apply_overrides([
            "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
            "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
            "data.batch_size=8", "fed.num_clients=2", "model.text_encoder_mode=head",
            "model.fuse_hot_path=true", "model.use_pallas=true", f"fed.rounds={rounds}",
            f"train.snapshot_dir={where}", f"model.dropout_rate={dropout}",
        ])

    data = make_synthetic_mind(num_news=300, num_train=64, num_valid=300, title_len=12,
                               his_len_range=(2, 10), seed=1)
    toks = np.random.default_rng(1).standard_normal((300, 12, 48)).astype(np.float32)
    reset_launch_counts()
    card = Trainer(cfg(3, tmp_path / "card", 0.0), data, toks, device=cuda).run()
    counts = launch_counts()
    for name in ("additive_pool", "fused_history_score", "fused_gather_encode",
                 "fused_gather_encode_bwd", "fused_history_score_bwd"):
        assert counts[name] > 0, name
    plain = Trainer(cfg(3, tmp_path / "cpu", 0.0), data, toks, device="cpu").run()
    np.testing.assert_allclose([h.train_loss for h in card], [h.train_loss for h in plain],
                               rtol=1e-5, atol=1e-6)
    assert all(0.0 <= v <= 1.0 for h in card for v in h.val_metrics.values())

    straight = Trainer(cfg(3, tmp_path / "a", 0.2), data, toks, device=cuda)
    hist = straight.run()
    Trainer(cfg(2, tmp_path / "b", 0.2), data, toks, device=cuda).run()
    resumed = Trainer(cfg(3, tmp_path / "b", 0.2), data, toks, device=cuda)
    assert resumed.start_round == 2
    last = resumed.run()[0]
    assert last.train_loss == hist[2].train_loss and last.val_metrics == hist[2].val_metrics
    for a, b in zip(straight.states, resumed.states):
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(p, q)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ------------------------------------------------ decoupled mode on the card
def _decoupled(dev, clients: int = 2):
    """A small decoupled setup (ragged widths) on ``dev``: config, the
    clients, the step, the news update, token states and a table."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import (
        build_fed_train_step,
        build_news_update_step,
        encode_all_news,
        init_client_state,
        replicate_state,
    )

    cfg = ExperimentConfig().apply_overrides([
        "model.news_dim=40", "model.num_heads=5", "model.head_dim=8", "model.query_dim=12",
        "model.bert_hidden=48", "data.max_his_len=7", "data.max_title_len=7",
        "data.batch_size=6", f"fed.num_clients={clients}", "model.fuse_hot_path=true",
        "model.use_pallas=true", "model.dropout_rate=0.0", "optim.user_lr=3e-3",
        "optim.news_lr=3e-3",
    ])
    model = init_params(NewsRecommender(cfg.model), seed=1).to(dev)
    states = replicate_state(init_client_state(model, cfg), clients)
    strategy = get_strategy("param_avg")
    toks = _t(np.random.default_rng(2).standard_normal((300, 7, 48)), dev)
    return (cfg, states, build_fed_train_step(model, cfg, strategy, device=dev),
            build_news_update_step(model, cfg, strategy, chunk=128, device=dev), toks,
            encode_all_news(model, toks, chunk=128, device=dev))


def _decoupled_batch(rng, clients: int = 2) -> dict:
    return {"candidates": rng.integers(0, 300, (clients, 6, 5)),
            "history": np.where(rng.random((clients, 6, 7)) < 0.3, 0,
                                rng.integers(1, 300, (clients, 6, 7))),
            "labels": np.zeros((clients, 6), np.int64)}


def _params_close(a, b) -> None:
    """The trajectory bars: rtol 2e-4 / atol 1e-4, the zero-gradient leaves
    within 1e-3."""
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        got, want = p.detach().float().cpu().numpy(), q.detach().float().cpu().numpy()
        if name.endswith(("w_k.bias", "att_fc2.bias")):
            assert np.abs(got - want).max() < 1e-3, name
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4, err_msg=name)


def test_decoupled_step_on_the_card_matches_the_cpu(cuda, rng):
    """Two decoupled steps on the kernel route: kernel E's dx and dcand reach
    the gathered vectors (the accumulators match the CPU's plain route), B
    and E launch, C and D do not."""
    batches = [_decoupled_batch(rng) for _ in range(2)]
    runs = {}
    for name, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        with _one_cpu_thread():
            _, states, step, _, _, table = _decoupled(dev)
            reset_launch_counts()
            losses = [step(states, b, table)[1]["loss"] for b in batches]
        runs[name] = states, losses, launch_counts()
    (card, card_losses, counts), (cpu, cpu_losses, _) = runs["card"], runs["cpu"]
    assert counts["fused_history_score"] == 4 and counts["fused_history_score_bwd"] == 4
    assert counts["fused_gather_encode"] == counts["fused_gather_encode_bwd"] == 0
    for a, b in zip(card_losses, cpu_losses):
        _close(a, b, torch.float32)
    for sc, sp in zip(card, cpu):
        acc_c, acc_p = sc.news_grad_accum.cpu(), sp.news_grad_accum
        assert float(acc_p.abs().max()) > 0
        np.testing.assert_allclose(acc_c.numpy(), acc_p.numpy(), rtol=1e-5,
                                   atol=1e-4 * float(acc_p.abs().max()))
        _params_close(sc.model, sp.model)


def test_scatter_add_rows_repeats_to_the_bit_on_the_card(cuda, rng):
    from fedrec_tpu_torch.train import scatter_add_rows

    ids = torch.from_numpy(np.concatenate([rng.integers(1, 5000, 30000), np.zeros(8000, np.int64)]))
    ids = ids[torch.from_numpy(rng.permutation(ids.numel()))].to(cuda)
    rows = _t(rng.standard_normal((ids.numel(), 400)), cuda)
    base = _t(rng.standard_normal((6000, 400)), cuda)
    got, again = base.clone(), base.clone()
    scatter_add_rows(got, ids, rows)
    scatter_add_rows(again, ids, rows)
    assert torch.equal(got, again)
    want = base.double().index_add_(0, ids, rows.double())
    # an f32 sum of n unit-scale terms drifts by about sqrt(n) ulps; a wrong
    # or missing term moves a row by O(1)
    lengths = torch.bincount(ids, minlength=6000).double()[:, None]
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * (1 + lengths)).all()), float(err.max())


def test_news_update_on_the_card_matches_the_cpu(cuda, rng):
    """One epoch-end news update after a step: kernel A runs under autograd
    (its backward the plain pool's), and the updated heads and tables
    match the CPU's at the trajectory bars; two runs on the card agree to
    the bit."""
    batch = _decoupled_batch(rng)
    out = {}
    for name, dev in (("card", cuda), ("again", cuda), ("cpu", torch.device("cpu"))):
        with _one_cpu_thread():
            _, states, step, update, toks, table = _decoupled(dev)
            step(states, batch, table)
            reset_launch_counts()
            states, tables = update(states, toks)
        out[name] = states, tables, launch_counts()
        assert all(float(st.news_grad_accum.abs().max()) == 0 for st in states)
    (card, card_tables, counts), (cpu, cpu_tables, _) = out["card"], out["cpu"]
    # per client: 300 rows in 3 chunks, forward + re-encode
    assert counts["additive_pool"] == 2 * 2 * 3
    for sc, sp, tc, tp in zip(card, cpu, card_tables, cpu_tables):
        _params_close(sc.model, sp.model)
        np.testing.assert_allclose(tc.cpu().numpy(), tp.numpy(), rtol=2e-4, atol=1e-4)
    for sa, sb in zip(card, out["again"][0]):
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            assert torch.equal(p, q)
    assert all(torch.equal(a, b) for a, b in zip(card_tables, out["again"][1]))


def _clustered_table(rng, n: int, d: int, centers: int) -> np.ndarray:
    c = rng.standard_normal((centers, d)) * 2.0
    return (c[rng.integers(0, centers, n)] + 0.25 * rng.standard_normal((n, d))).astype(np.float32)


def test_kmeans_repeats_bitwise_on_the_card(cuda, rng):
    """Two k-means builds on the card give the same bits (sorted segment
    sums, no atomics); every row goes to its nearest centroid by float64
    distances (up to f32 rounding, 1e-4 relative); and the CPU route from
    the same init agrees but at near-ties. A point between two centroids
    may fall either way under another summation order (1 in 20,000 did on
    the H100), which moves those two centroids by about its distance over
    the cluster's size: the centroids compare at 1e-2."""
    from fedrec_tpu_torch.serving.retrieval import _lloyd, kmeans

    vecs = _t(_clustered_table(rng, 20000, 48, 64), cuda)
    first = kmeans(vecs, 64, iters=10, seed=3, device=cuda)
    again = kmeans(vecs, 64, iters=10, seed=3, device=cuda)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    x, c = vecs.cpu().double(), first[0].cpu().double()
    d = (x * x).sum(1, keepdim=True) - 2 * x @ c.T + (c * c).sum(1)[None, :]
    chosen = d.gather(1, first[1].cpu().long()[:, None])[:, 0]
    nearest = d.min(1).values
    assert bool((chosen <= nearest + 1e-4 * (1 + nearest.abs())).all())
    init = vecs.cpu()[torch.randperm(20000, generator=torch.Generator().manual_seed(3))[:64]]
    with _one_cpu_thread():
        cents, assign = _lloyd(vecs.cpu(), init, 10)
    assert float((first[1].cpu() == assign).float().mean()) >= 0.999
    np.testing.assert_allclose(first[0].cpu().numpy(), cents.numpy(), atol=1e-2)


@pytest.mark.parametrize("n_probe", [4, 64])
def test_two_stage_on_the_card_matches_the_cpu_route(cuda, rng, n_probe, monkeypatch):
    """The probe -> gather -> rerank route with kernel B's user vectors on
    the card against the same index on the CPU route; the rerank's column
    blocks leave every bit as it was."""
    from fedrec_tpu_torch.config import ModelConfig
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.serving import TwoStageIndex, build_index, build_two_stage_fn
    from fedrec_tpu_torch.serving import retrieval

    cfg = ModelConfig(news_dim=48, num_heads=4, head_dim=12, query_dim=16, bert_hidden=32,
                      fuse_hot_path=True, use_pallas=True)
    tower = init_params(NewsRecommender(cfg), seed=2).eval().user_encoder
    table = torch.from_numpy(_clustered_table(rng, 20000, 48, 64))
    valid = rng.random(20000) > 0.05
    hist = torch.from_numpy(rng.integers(1, 20000, (37, 50)))
    cpu_index = build_index(table, num_clusters=64, n_probe=n_probe, valid_mask=valid,
                            exact_threshold=1024, device="cpu")
    card_index = TwoStageIndex(news_vecs=table.to(cuda), valid_mask=valid, exact=False,
                               centroids=cpu_index.centroids.to(cuda),
                               members=cpu_index.members.to(cuda), n_probe=n_probe)
    with _one_cpu_thread():
        want_ids, want_scores = build_two_stage_fn(cpu_index, device="cpu")(tower, hist)
    card_tower = init_params(NewsRecommender(cfg), seed=2).eval().user_encoder.to(cuda)
    reset_launch_counts()
    ids, scores = build_two_stage_fn(card_index, device=cuda)(card_tower, hist)
    assert launch_counts()["fused_history_score"] == 1
    np.testing.assert_allclose(scores.cpu().numpy(), want_scores.numpy(), atol=1e-5, rtol=1e-5)
    ws = want_scores.numpy()
    gaps = np.abs(np.diff(ws, axis=1))
    inf = np.full((ws.shape[0], 1), np.inf)
    decided = (np.concatenate([inf, gaps], 1) > 1e-4) & (np.concatenate([gaps, inf], 1) > 1e-4)
    np.testing.assert_array_equal(ids.cpu().numpy()[decided], want_ids.numpy()[decided])
    monkeypatch.setattr(retrieval, "_RERANK_BYTES", 4 * 48 * 37 * 100)  # 100 columns a block
    blocked = build_two_stage_fn(card_index, device=cuda)(card_tower, hist)
    assert torch.equal(blocked[0], ids) and torch.equal(blocked[1], scores)


def test_refresh_token_states_reach_the_card_unchanged(cuda, rng, tmp_path):
    """A refresh's token-state load (memory map, two pinned buffers taking
    turns, asynchronous copies on a side stream) gives the file's bits."""
    from fedrec_tpu_torch.serving import server

    want = rng.standard_normal((5000, 6, 16)).astype(np.float32)
    np.save(tmp_path / "states.npy", want)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        got, load_ms, h2d_ms = server._load_token_states(str(tmp_path / "states.npy"), cuda,
                                                         torch.float32)
    side.synchronize()
    assert got.device.type == "cuda" and load_ms >= 0 and h2d_ms >= 0
    assert np.array_equal(got.cpu().numpy(), want)
    half, _, _ = server._load_token_states(str(tmp_path / "states.npy"), cuda, torch.bfloat16)
    assert torch.equal(half.cpu(), torch.from_numpy(want).to(torch.bfloat16))


# ------------------------------------ per-example gradients (vmap rules)
def _per_example_pool_grads(pool, x, w, mask):
    """vmap(grad) of a squared pool over the examples of ``x``: each
    example's gradient of the weights and of its own rows."""
    def loss(w1, b1, w2, xe, me):
        return pool(xe, w1, b1, w2, me).square().sum()

    return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3)),
                           in_dims=(None, None, None, 0, None if mask is None else 0))(
        *w, x, mask)


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pool_per_example_grads_fold_into_one_launch(cuda, rng, long, masked):
    """Kernels A and A2 under vmap(grad): the per-example gradients equal
    the plain route's at A's gradient bar, and the forward launches once
    for all the examples, whatever their number."""
    pool = additive_pool_long if long else additive_pool
    name = "additive_pool_long" if long else "additive_pool"
    D, hd = 48, 24
    w = [_t(rng.standard_normal(s) / np.sqrt(s[0]), cuda) for s in [(D, hd), (hd,), (hd,)]]
    for b in (2, 8):
        x = _t(rng.standard_normal((b, 5, 7, D)), cuda)
        m = _t((rng.random((b, 5, 7)) > 0.3).astype(np.float32), cuda) if masked else None
        reset_launch_counts()
        got = _per_example_pool_grads(pool, x, w, m)
        assert launch_counts()[name] == 1, b
        with _one_cpu_thread():
            want = _per_example_pool_grads(additive_pool_plain, x.cpu(), [t.cpu() for t in w],
                                           None if m is None else m.cpu())
        for what, a, r in zip(("dw1", "db1", "dw2", "dx"), got, want):
            _close_grad(a, r, torch.float32, what)


def test_flash_per_example_grads_fold_into_one_launch_each(cuda, rng):
    """F1 forward, F2 and F3 backward under vmap(grad) of a projected
    attention: the per-example weight gradients equal the plain route's,
    and each kernel launches once whatever B."""
    L, h, d = 33, 4, 20
    wq = _t(rng.standard_normal((h * d, h * d)) / np.sqrt(h * d), cuda)

    def loss(w, x):
        q = (x @ w).reshape(1, L, h, d)
        kv = x.reshape(1, L, h, d)
        return flash_attention(q, kv, kv).square().sum()

    for b in (2, 8):
        x = _t(rng.standard_normal((b, L, h * d)), cuda)
        reset_launch_counts()
        got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)), in_dims=(None, 0))(wq, x)
        counts = launch_counts()
        assert counts["flash_forward"] == counts["flash_backward_dq"] == 1, b
        assert counts["flash_backward_dkv"] == 1, b
        with _one_cpu_thread():
            want = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)), in_dims=(None, 0))(
                wq.cpu(), x.cpu())
        for what, a, r in zip(("dw", "dx"), got, want):
            _close_grad(a, r, torch.float32, what)


def test_a_mapped_pool_weight_raises_on_the_card(cuda, rng):
    x = _t(rng.standard_normal((3, 5, 7, 48)), cuda)
    w1 = _t(rng.standard_normal((3, 48, 24)), cuda)
    b1, w2 = _t(rng.standard_normal(24), cuda), _t(rng.standard_normal(24), cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match=r"operand 1 of shape \(3, 48, 24\) is mapped"):
        torch.func.vmap(lambda xe, we: additive_pool(xe, we, b1, w2))(x, w1)
    assert launch_counts()["additive_pool"] == 0


def _dp_cfg(*over):
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.news_dim=40", "model.num_heads=5", "model.head_dim=8", "model.query_dim=12",
        "model.bert_hidden=48", "data.max_his_len=7", "data.max_title_len=7",
        "data.batch_size=6", "fed.num_clients=2", "model.text_encoder_mode=head",
        "model.dropout_rate=0.0", "privacy.enabled=1", "privacy.sigma=0.5", *over])


def test_dp_grads_on_the_card_kernel_route_match_the_plain_route(cuda, rng):
    """``per_example_dp_grads`` on the kernel route (A both pools, F1-F3)
    against the dense route on the CPU: clipped mean gradients at the
    gradient bar; A launches twice and F1-F3 once, for B = 3 and 12."""
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train.step import per_example_dp_grads

    toks = rng.standard_normal((300, 7, 48)).astype(np.float32)
    for b in (3, 12):
        cand, hist = rng.integers(1, 300, (b, 5)), rng.integers(0, 300, (b, 7))
        outs = {}
        for route, dev, over in (("kernel", cuda, "model.use_pallas=1"),
                                 ("dense", torch.device("cpu"), "model.attn_impl=dense")):
            cfg = _dp_cfg(over)
            model = init_params(NewsRecommender(cfg.model), seed=1).to(dev)
            reset_launch_counts()
            with _one_cpu_thread():
                outs[route] = per_example_dp_grads(
                    model, _t(toks, dev), _t(cand, dev, torch.int64), _t(hist, dev, torch.int64),
                    torch.zeros(b, dtype=torch.int64, device=dev), 2.0)
            if route == "kernel":
                counts = launch_counts()
                assert counts["additive_pool"] == 2 and counts["flash_forward"] == 1, counts
                assert counts["flash_backward_dq"] == counts["flash_backward_dkv"] == 1, counts
        k, d = outs["kernel"], outs["dense"]
        np.testing.assert_allclose(float(k[0]), float(d[0]), rtol=1e-5, atol=1e-6)
        for a, r in zip(k[1] + k[2], d[1] + d[2]):
            _close_grad(a, r, torch.float32, "dp grad")


def test_robust_sync_repeats_bitwise_on_the_card(cuda):
    from fedrec_tpu_torch.fed.robust import robust_aggregate

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = [[torch.randn((400, 400), generator=gen, device=cuda),
               torch.randn((200,), generator=gen, device=cuda)] for _ in range(16)]
    params[3] = [p * 1000 for p in params[3]]
    params[5][0][7, 9] = float("nan")
    w = np.ones(16, np.float32)
    w[11] = 0.0
    for method in ("clip", "trimmed_mean", "median"):
        first = robust_aggregate(params, w, method, trim_k=2, clip_norm=5.0)
        again = robust_aggregate(params, w, method, trim_k=2, clip_norm=5.0)
        for a, b in zip(first, again):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), method
        with _one_cpu_thread():
            cpu = robust_aggregate([[p.cpu() for p in c] for c in params], w, method, trim_k=2,
                                   clip_norm=5.0)
        for x, y in zip(first[0], cpu[0]):
            np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


def test_sentry_trajectory_is_bitwise_on_and_off_on_the_card(cuda, rng):
    """Three steps of the fused joint route and of the decoupled route with
    dropout on: parameters, moments and generators to the bit with the
    sentry on and off."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import (build_fed_train_step, encode_all_news,
                                        init_client_state, replicate_state)

    toks = _t(rng.standard_normal((300, 7, 48)), cuda)
    batches = [_decoupled_batch(rng) for _ in range(3)]
    for mode in ("joint", "decoupled"):
        runs = []
        for sentry in (1, 0):
            cfg = ExperimentConfig().apply_overrides([
                "model.news_dim=40", "model.num_heads=5", "model.head_dim=8",
                "model.query_dim=12", "model.bert_hidden=48", "data.max_his_len=7",
                "data.max_title_len=7", "data.batch_size=6", "fed.num_clients=2",
                "model.fuse_hot_path=true", "model.use_pallas=true", "model.dropout_rate=0.2",
                f"obs.health.sentry={sentry}",
                f"model.text_encoder_mode={'head' if mode == 'joint' else 'table'}"])
            model = init_params(NewsRecommender(cfg.model), seed=1).to(cuda)
            states = replicate_state(init_client_state(model, cfg), 2)
            table = toks if mode == "joint" else encode_all_news(model, toks, device=cuda)
            step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=cuda)
            for b in batches:
                states, m = step(states, b, table)
            assert ("health.grad_norm" in m) == bool(sentry)
            runs.append([t for st in states for t in (*st.model.parameters(), *st.opt_user.mu,
                                                       st.generator.get_state())])
        assert all(torch.equal(a, b) for a, b in zip(*runs)), mode


# ------------------------------------------------ the cohort engine on the card
def _cohort_trainer(dev, where, rounds=2, **over):
    """A small sampled-population trainer (16 logical clients over 2 slots,
    2 resident sidecars, the rest spilled under ``where``) on ``dev``."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.train import Trainer

    cfg = ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
        "data.batch_size=8", "fed.num_clients=2", "model.text_encoder_mode=head",
        "model.fuse_hot_path=true", "model.use_pallas=true", f"fed.rounds={rounds}",
        "train.snapshot_dir=", "fed.population.num_clients=16",
        "fed.population.over_select=1.5", "fed.population.resident_cap=2",
        f"fed.population.spill_dir={where}", "chaos.enabled=true", "chaos.pop_drop_rate=0.2",
        "model.dropout_rate=0.2", "optim.user_lr=3e-3", "optim.news_lr=3e-3",
        *[f"{k}={v}" for k, v in over.items()],
    ])
    data = make_synthetic_mind(num_news=300, num_train=256, num_valid=32, title_len=12,
                               his_len_range=(2, 10), seed=1)
    toks = np.random.default_rng(1).standard_normal((300, 12, 48)).astype(np.float32)
    return Trainer(cfg, data, toks, device=dev)


def test_sidecar_round_trip_on_the_card_is_bitwise(cuda, tmp_path):
    """A slot's sidecar written back, spilled, reloaded and installed into
    another slot on the card is the original to the bit: moments, counts,
    step and both generator states."""
    from fedrec_tpu_torch.fed.population import ClientPopulation

    t = _cohort_trainer(cuda, tmp_path / "spill")
    t.run()
    original = t._read_sidecar(0)
    assert int(original["step"]) > 0 and original["generator"].size > 0
    store = ClientPopulation(4, 64, resident_cap=1, spill_dir=tmp_path / "probe")
    store.put_sidecar(0, original)
    store.put_sidecar(1, t._read_sidecar(1))  # spills client 0
    assert store.spill_count == 1
    t._write_sidecar(1, store.get_sidecar(0))
    again = t._read_sidecar(1)
    for key in original:
        xs = original[key] if isinstance(original[key], list) else [original[key]]
        ys = again[key] if isinstance(again[key], list) else [again[key]]
        assert len(xs) == len(ys), key
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=key)
    a, b = t.states[0], t.states[1]
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.noise_generator.get_state(), b.noise_generator.get_state())
    assert all(torch.equal(x, y) for x, y in zip(a.opt_user.mu + a.opt_news.nu,
                                                 b.opt_user.mu + b.opt_news.nu))


def test_fedopt_step_on_the_card_equals_the_numpy_step(cuda, tmp_path):
    """The round-end FedAdam step on card-resident parameters: every slot
    ends with the numpy step of the round's entry global and client 0's mean,
    to the bit."""
    from fedrec_tpu_torch.fed import ServerOptimizer

    t = _cohort_trainer(cuda, tmp_path / "spill", rounds=1, **{"fed.server_opt": "adam",
                                                                "fed.server_lr": 0.01})
    seen = []
    step = t.server_opt.step
    t.server_opt.step = lambda g, m: (seen.append(([x.copy() for x in g], [x.copy() for x in m])),
                                      step(g, m))[1]
    t.run()
    (g, m), = seen
    want = ServerOptimizer("adam", 0.01, 0.9).step(g, m)
    for c in range(len(t.states)):
        for p, w in zip(t._slot_params(c), want):
            np.testing.assert_array_equal(p.detach().cpu().numpy(), w)


def test_sampled_round_kernel_route_matches_dense_on_the_card(cuda, tmp_path):
    """Two sampled rounds (dropout 0) on the kernel route and on the dense
    route: the same cohorts, the round losses at rtol 1e-5 / atol 1e-6, the
    slots' parameters at the trajectory bars."""
    runs = []
    for route in ("true", "false"):
        t = _cohort_trainer(cuda, tmp_path / route, **{
            "model.dropout_rate": 0.0, "model.fuse_hot_path": route,
            "model.use_pallas": route})
        reset_launch_counts()
        hist = t.run()
        runs.append((t, hist, launch_counts()))
    (tk, hk, ck), (td, hd, cd) = runs
    assert ck["fused_gather_encode"] > 0 and ck["fused_history_score_bwd"] > 0
    assert not any(cd.values())
    assert tk.cohort_history == td.cohort_history
    np.testing.assert_allclose([h.train_loss for h in hk], [h.train_loss for h in hd],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(tk.states, td.states):
        _params_close(a.model, b.model)


def test_news_grad_accum_marker_gives_the_same_next_step_on_the_card(cuda, rng):
    """Decoupled mode: after an epoch's news update the accumulator is all
    zero; a slot that carries it as the empty marker (None, allocated afresh
    by the step) takes the same next step, to the bit, as one holding the
    full zero tensor."""
    batches = [_decoupled_batch(rng) for _ in range(2)]
    runs = []
    for marker in (False, True):
        _, states, step, update, toks, table = _decoupled(cuda)
        states, _ = step(states, batches[0], table)
        states, tables = update(states, toks)
        assert all(not bool(st.news_grad_accum.any()) for st in states)
        if marker:
            for st in states:
                st.news_grad_accum = None
        states, metrics = step(states, batches[1], tables[0])
        runs.append((states, metrics["loss"]))
    (full, loss_full), (mark, loss_mark) = runs
    assert torch.equal(loss_full, loss_mark)
    for a, b in zip(full, mark):
        assert torch.equal(a.news_grad_accum, b.news_grad_accum)
        assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))


# ------------------------------------------------------------ the trunk (finetune)
def _trunk_tokens(rng, n: int, L: int, vocab: int) -> np.ndarray:
    tokens = np.zeros((n, 2, L), np.int64)
    tokens[:, 0] = rng.integers(0, vocab, size=(n, L))
    tokens[:, 1] = 1
    tokens[0] = 0            # news id 0's row: every key padded
    tokens[2, :, 7:] = 0     # a short title
    return tokens


@pytest.mark.parametrize("width", ["small", "full_two_layers"])
def test_trunk_on_the_card_matches_the_cpu_in_float64(cuda, rng, width):
    """``precompute_token_states`` on the card (TF32 off) against the same
    trunk in float64 on the CPU, every real title within 1e-5 (small) or
    1e-4 (768 wide, two layers: reductions of 768-3072); the all-padding
    row against the CPU in float32 (its uniform attention comes from f32
    absorbing the -1e9 bias, as in JAX)."""
    from fedrec_tpu_torch.models.bert import (
        DistilBert,
        DistilBertConfig,
        init_trunk_params,
        precompute_token_states,
    )

    cfg = (DistilBertConfig(vocab_size=500, dim=48, n_layers=2, n_heads=4, hidden_dim=96)
           if width == "small" else DistilBertConfig(n_layers=2))
    tol = 1e-5 if width == "small" else 1e-4
    sd = init_trunk_params(0, cfg)
    tokens = _trunk_tokens(rng, 37, 50, cfg.vocab_size)
    got = precompute_token_states(sd, tokens, cfg, chunk=16, device=cuda)
    ref = DistilBert(cfg, dtype=torch.float64)
    ref.load_state_dict({k: v.double() for k, v in sd.items()})
    cpu32 = DistilBert(cfg)
    cpu32.load_state_dict(sd)
    t = torch.from_numpy(tokens)
    with torch.no_grad(), _one_cpu_thread():
        want = ref(t[1:, 0], t[1:, 1]).numpy()
        want0 = cpu32(t[:1, 0], t[:1, 1]).numpy()
    np.testing.assert_allclose(got[1:], want, atol=tol, rtol=0)
    np.testing.assert_allclose(got[:1], want0, atol=tol, rtol=0)


def _finetune_setup(dev, fuse: bool):
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import TrainBatcher, index_samples, make_synthetic_mind
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import build_fed_train_step, init_client_state, replicate_state

    cfg = ExperimentConfig().apply_overrides([
        "model.text_encoder_mode=finetune", "model.news_dim=32", "model.num_heads=4",
        "model.head_dim=8", "model.query_dim=16", "model.bert_hidden=48",
        "model.trunk_layers=2", "model.trunk_heads=4", "model.trunk_ffn=96",
        "model.trunk_vocab=2000", "model.trunk_dropout=0", "data.max_his_len=10",
        "data.max_title_len=12", "data.batch_size=8", "fed.num_clients=2",
        "optim.user_lr=1e-3", "optim.news_lr=1e-3", f"model.fuse_hot_path={fuse}",
        f"model.use_pallas={fuse}",
    ])
    data = make_synthetic_mind(num_news=80, num_train=64, num_valid=8, title_len=12,
                               vocab=2000, his_len_range=(2, 10), seed=2)
    model = init_params(NewsRecommender(cfg.model), seed=4).to(dev)
    states = replicate_state(init_client_state(model, cfg, seed=0), 2)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=dev)
    ix = index_samples(data.train_samples, data.nid2index, 10)
    batches = [{"candidates": b.candidates, "history": b.history, "labels": b.labels}
               for b in TrainBatcher(ix, 8, 4, seed=0).epoch_batches_sharded(2, 0)][:3]
    return states, step, batches, torch.from_numpy(data.news_tokens).to(dev)


def test_finetune_step_launches_b_and_e_and_tracks_the_dense_route(cuda):
    """Three finetune steps of 2 clients, user dropout on, trunk dropout 0:
    on the kernel route B and E launch on every client step, C and D never
    (there is no token-state table); the losses and parameters follow the
    dense route at the trajectory bars (the zero-gradient leaves, trunk key
    biases included, within 2 x lr x steps: Adam's walk on rounding noise)."""
    runs = []
    for fuse in (True, False):
        states, step, batches, table = _finetune_setup(cuda, fuse)
        losses, per_step = [], []
        for batch in batches:
            reset_launch_counts()
            states, m = step(states, batch, table)
            torch.cuda.synchronize()
            per_step.append(launch_counts())
            losses.append(m["loss"].cpu().numpy())
            assert m["unique_overflow"] == 0
        runs.append((states, losses, per_step))
    (sk, lk, ck), (sd, ld, cd) = runs
    for counts in ck:
        assert counts["fused_history_score"] == counts["fused_history_score_bwd"] == 2
        assert counts["fused_gather_encode"] == counts["fused_gather_encode_bwd"] == 0
    assert not any(v for counts in cd for v in counts.values())
    np.testing.assert_allclose(np.array(lk), np.array(ld), rtol=1e-5, atol=1e-6)
    for a, b in zip(sk, sd):
        for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            got, want = p.detach().cpu().numpy(), q.detach().cpu().numpy()
            if name.endswith(("w_k.bias", "att_fc2.bias", "k_lin.bias")):
                assert np.abs(got - want).max() <= 2 * 1e-3 * 3, name
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4, err_msg=name)


def _family_setup(dev, use_pallas: bool, mode: str = "head", tower: str = "gru",
                  fuse: bool = False):
    """K=2 clients of the GRU tower (or ``tower``) and the CNN head at small
    widths, three batches, the token states on ``dev``."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import TrainBatcher, index_samples, make_synthetic_mind
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import build_fed_train_step, init_client_state, replicate_state

    cfg = ExperimentConfig().apply_overrides([
        f"model.text_encoder_mode={mode}", "model.news_dim=32", "model.num_heads=4",
        "model.head_dim=8", "model.query_dim=16", "model.bert_hidden=48",
        f"model.user_tower={tower}", "model.text_head_arch=cnn", "model.cnn_kernel=4",
        "data.max_his_len=10", "data.max_title_len=12", "data.batch_size=8",
        "fed.num_clients=2", "optim.user_lr=1e-3", "optim.news_lr=1e-3",
        f"model.use_pallas={use_pallas}", f"model.fuse_hot_path={fuse}",
    ])
    data = make_synthetic_mind(num_news=80, num_train=64, num_valid=8, title_len=12,
                               his_len_range=(2, 10), seed=2)
    model = init_params(NewsRecommender(cfg.model), seed=4).to(dev)
    states = replicate_state(init_client_state(model, cfg, seed=0), 2)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=dev)
    ix = index_samples(data.train_samples, data.nid2index, 10)
    batches = [{"candidates": b.candidates, "history": b.history, "labels": b.labels}
               for b in TrainBatcher(ix, 8, 4, seed=0).epoch_batches_sharded(2, 0)][:3]
    toks = torch.from_numpy(np.random.default_rng(5).standard_normal((80, 12, 48)).astype(
        np.float32)).to(dev)
    return states, step, batches, toks


@pytest.mark.parametrize("mode", ["head", "table"])
def test_gru_cnn_kernel_route_tracks_the_dense_route(cuda, mode):
    """Three steps of the GRU tower and the CNN head with user dropout on:
    under ``use_pallas`` kernel A pools both towers (joint mode: two
    launches a client step; decoupled mode: the GRU pool's one), the
    losses and parameters follow the dense route at the trajectory bars."""
    from fedrec_tpu_torch.train import encode_all_news

    runs = []
    for use_pallas in (True, False):
        states, step, batches, toks = _family_setup(cuda, use_pallas, mode)
        table = toks if mode == "head" else encode_all_news(states[0].model, toks, device=cuda)
        losses, per_step = [], []
        for batch in batches:
            reset_launch_counts()
            states, m = step(states, batch, table)
            torch.cuda.synchronize()
            per_step.append(launch_counts())
            losses.append(m["loss"].cpu().numpy())
        runs.append((states, losses, per_step))
    (sk, lk, ck), (sd, ld, cd) = runs
    for counts in ck:
        assert counts["additive_pool"] == (4 if mode == "head" else 2)
        assert counts["fused_gather_encode"] == counts["fused_history_score"] == 0
    assert not any(v for counts in cd for v in counts.values())
    np.testing.assert_allclose(np.array(lk), np.array(ld), rtol=1e-5, atol=1e-6)
    for a, b in zip(sk, sd):
        for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            got, want = p.detach().cpu().numpy(), q.detach().cpu().numpy()
            if name.endswith("att_fc2.bias"):
                assert np.abs(got - want).max() <= 2 * 1e-3 * 3, name
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4, err_msg=name)


def test_cnn_head_under_fuse_hot_path_launches_b_and_e_only(cuda):
    """The CNN head with the MHA tower under ``fuse_hot_path``: B and E on
    every client step, C and D never (the dense gather + encode, as in
    JAX)."""
    states, step, batches, toks = _family_setup(cuda, True, tower="mha", fuse=True)
    for batch in batches:
        reset_launch_counts()
        states, m = step(states, batch, toks)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["fused_history_score"] == counts["fused_history_score_bwd"] == 2
        assert counts["fused_gather_encode"] == counts["fused_gather_encode_bwd"] == 0
        assert counts["additive_pool"] == 2  # the CNN pool, a launch a client
        assert np.isfinite(m["loss"].cpu().numpy()).all()


def test_cnn_head_fused_route_tracks_the_dense_route(cuda):
    """The CNN head under the MHA tower: three steps on the kernel route
    (``fuse_hot_path`` and ``use_pallas``: kernel A in the CNN pool, B and E
    on the user tower) against the dense route (no kernel), losses and
    parameters at the trajectory bars; the leaves whose true gradient is
    zero (the key bias, both pools' fc2 bias) at 2 x lr x steps."""
    runs = []
    for kernels in (True, False):
        states, step, batches, toks = _family_setup(cuda, kernels, tower="mha", fuse=kernels)
        reset_launch_counts()
        losses = []
        for batch in batches:
            states, m = step(states, batch, toks)
            losses.append(m["loss"].cpu().numpy())
        torch.cuda.synchronize()
        runs.append((states, losses, launch_counts()))
    (sk, lk, ck), (sd, ld, cd) = runs
    assert ck["fused_history_score_bwd"] == 2 * len(lk) and not any(cd.values())
    np.testing.assert_allclose(np.array(lk), np.array(ld), rtol=1e-5, atol=1e-6)
    for a, b in zip(sk, sd):
        for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            got, want = p.detach().cpu().numpy(), q.detach().cpu().numpy()
            if name.endswith(("att_fc2.bias", "w_k.bias")):
                assert np.abs(got - want).max() <= 2 * 1e-3 * 3, name
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4, err_msg=name)


def test_cnn_product_matches_float64_with_tf32_off(cuda, rng):
    """The CNN head's conv as one (L, k * 768) x (k * 768, 400) product on
    the card, TF32 off, against float64 on the CPU at full width."""
    from fedrec_tpu_torch.models.encoders import CnnTextHead
    from fedrec_tpu_torch.params import init_params

    head = init_params(CnnTextHead(news_dim=400, bert_hidden=768, kernel=3), seed=1).to(cuda)
    x = _t(rng.standard_normal((64, 50, 768)), cuda)
    with torch.no_grad():
        win = head.windows(x)
        got = torch.nn.functional.linear(win, head.conv.weight, head.conv.bias)
    with _one_cpu_thread():
        w64 = head.conv.weight.detach().double().cpu()
        want = win.double().cpu() @ w64.T + head.conv.bias.detach().double().cpu()
    err = float((got.double().cpu() - want).abs().max())
    assert err <= 1e-4, err
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ------------------------------------------------ codecs and the coordinator
@pytest.mark.parametrize("codec", ["int8", "sign1bit", "topk", "countsketch", "randproj"])
def test_codec_twin_on_the_card_matches_the_wire_decode(cuda, rng, codec):
    """``comms.torch_encode_decode`` on CUDA tensors against the numpy
    decode of the same tensor's wire payload: int8 and topk to the bit;
    sign1bit's signs to the bit and its scale (``mean|x|``, summed in
    another order on the card than numpy's pairwise sum) within 2 f32 ulps;
    the sketches within 1e-6 of the leaf's scale."""
    from fedrec_tpu_torch import comms

    for i, shape in enumerate([(48, 32), (32,), (7, 5, 3), (1,)]):
        x = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        x.reshape(-1)[:2] = x.reshape(-1)[0]  # a magnitude tie
        got = comms.torch_encode_decode(_t(x, cuda), codec, 0.05, sketch_width=0.25,
                                        sketch_seed=3, leaf_id=i).cpu().numpy()
        want = comms.decode_leaf(comms.encode_leaf(x, codec, 0.05, sketch_width=0.25,
                                                   sketch_seed=3, leaf_id=i),
                                 codec, x.shape, sketch_seed=3, leaf_id=i)
        if codec in ("int8", "topk"):
            np.testing.assert_array_equal(got, want, err_msg=f"leaf {i}")
        elif codec == "sign1bit":
            np.testing.assert_array_equal(np.sign(got), np.sign(want), err_msg=f"leaf {i}")
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0, err_msg=f"leaf {i}")
        else:
            scale = float(np.abs(x).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale, err_msg=f"leaf {i}")


def test_coordinator_round_on_the_card_matches_the_emulation(cuda, tmp_path):
    """A 2-process coordinator world (the server training too) on cuda:0,
    2 rounds under int8: the server's global against the in-process
    emulation at the trajectory bars."""
    import os
    import pickle
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from fedrec_tpu_torch.cli.coordinator import _build_parser, config_from_args, emulate_world
    from fedrec_tpu_torch.data import load_mind_artifacts, make_synthetic_mind
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import from_flax
    from fedrec_tpu_torch.train import Trainer
    from fedrec_tpu_torch.train.checkpoint import load_state_bytes

    art = tmp_path / "UserData"
    art.mkdir()
    data = make_synthetic_mind(num_news=64, num_train=129, num_valid=16, title_len=6,
                               his_len_range=(2, 8), seed=3)
    np.save(art / "bert_news_index.npy", data.news_tokens)
    np.save(art / "token_states.npy",
            np.random.default_rng(4).standard_normal((64, 6, 48)).astype(np.float32))
    for name, obj in (("bert_nid2index.pkl", data.nid2index),
                      ("train_sam_uid.pkl", data.train_samples),
                      ("valid_sam_uid.pkl", data.valid_samples)):
        with open(art / name, "wb") as f:
            pickle.dump(obj, f)
    snaps = tmp_path / "snaps"
    small = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8",
             "model.query_dim=16", "model.bert_hidden=48", "data.max_his_len=8",
             "data.max_title_len=6", "train.eval_every=1000", "model.fuse_hot_path=true",
             "model.use_pallas=true", "fed.dcn_compress=int8"]
    argv = ["2", "8", "1", "--data-dir", str(art), "--device", "cuda", "--clients", "2",
            "--mode", "joint", *[x for kv in small for x in ("--set", kv)],
            "--set", f"train.snapshot_dir={snaps}", "--server-trains"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fedrec_tpu_torch.cli.coordinator", *argv, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i)],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs

    args = _build_parser().parse_args(argv)
    cfg = config_from_args(args, cuda)
    toks = np.load(art / "token_states.npy")
    trainers = []
    for i in range(2):
        c = config_from_args(args, cuda)
        c.train.snapshot_dir = ""
        c.data.num_shards, c.data.shard_index = 2, i
        trainers.append(Trainer(c, load_mind_artifacts(str(art)), toks, device=cuda))
    emulated = emulate_world(trainers, cfg, range(2))[0][-1]
    snap = load_state_bytes((snaps / "global_round_1.pt").read_bytes())
    model = NewsRecommender(cfg.model)
    from_flax(model.user_encoder, emulated[0])
    from_flax(model.news_tower, emulated[1])
    for part, module in (("user_params", model.user_encoder), ("news_params", model.news_tower)):
        for name, p in module.named_parameters():
            got, want = snap[part][name].numpy(), p.detach().numpy()
            if name.endswith(("w_k.bias", "att_fc2.bias")):
                assert float(np.abs(got - want).max()) < 1e-3, f"{part}.{name}"
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4,
                                           err_msg=f"{part}.{name}")
