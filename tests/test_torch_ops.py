"""Port parity for the kernels' plain versions (CPU): ``additive_pool``
(kernel A), ``fused_history_score`` / ``fused_user_vector`` (kernel B) and
``fused_gather_encode`` (kernel C), forward and, under autograd, backward
(kernels D and E), against the JAX package's Pallas kernels, run in
interpret mode as the JAX tests run them, on the same seeded numpy inputs.

Tolerances: f32 results differ only by summation order between XLA and
PyTorch (reductions of length <= 48 here), so f32 compares at 2e-5 (pool)
and 1e-5 (user tower, whose values are O(0.1)). bf16 compares against the
JAX kernel in its own band (atol 0.15 / rtol 0.05,
tests/test_fused_hot_path.py), since one ulp of bf16 is 2**-8 relative.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from fedrec_tpu.ops import additive_pool as jax_additive_pool
from fedrec_tpu.ops import fused_history_score as jax_fused_history_score
from fedrec_tpu.ops import fused_gather_encode as jax_fused_gather_encode
from fedrec_tpu.ops import fused_user_vector as jax_fused_user_vector
from fedrec_tpu_torch.ops import (
    TextHeadWeights,
    UserTowerWeights,
    additive_pool,
    additive_pool_plain,
    fused_gather_encode,
    fused_gather_encode_bwd,
    fused_gather_encode_plain,
    fused_history_score,
    fused_history_score_bwd,
    fused_history_score_plain,
    fused_user_vector,
    launch_counts,
    reset_launch_counts,
)


def _pool_inputs(rng, n=6, L=7, D=48, hidden=24):
    x = rng.standard_normal((n, L, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, hidden)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(hidden) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal(hidden) * 0.1).astype(np.float32)
    return x, w1, b1, w2


def _mask(rng, kind, n, L):
    if kind == "none":
        return None
    m = (rng.random((n, L)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if kind == "fully_masked_row":
        m[2] = 0.0
    return m


@pytest.mark.parametrize("kind", ["none", "partial", "fully_masked_row"])
def test_additive_pool_plain_matches_jax_kernel(rng, kind):
    x, w1, b1, w2 = _pool_inputs(rng)
    mask = _mask(rng, kind, *x.shape[:2])
    want = np.asarray(jax_additive_pool(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        None if mask is None else jnp.asarray(mask),
    ))
    t = torch.from_numpy
    got = additive_pool_plain(t(x), t(w1), t(b1), t(w2), None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the public wrapper takes the plain version on a CPU tensor
    got_w = additive_pool(t(x), t(w1), t(b1), t(w2), None if mask is None else t(mask))
    np.testing.assert_array_equal(got_w.numpy(), got.numpy())
    if kind == "fully_masked_row":
        assert np.all(got.numpy()[2] == 0.0)


def test_additive_pool_plain_leading_dims_and_bf16(rng):
    x, w1, b1, w2 = _pool_inputs(rng, n=6)
    x4 = x.reshape(2, 3, *x.shape[1:])
    want = np.asarray(jax_additive_pool(
        jnp.asarray(x4, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2)
    ).astype(jnp.float32))
    t = torch.from_numpy
    got = additive_pool_plain(t(x4).to(torch.bfloat16), t(w1), t(b1), t(w2))
    assert got.shape == (2, 3, x.shape[2]) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.15, rtol=0.05)


def _user_params(rng, d, q):
    ap = {
        k: {"kernel": (rng.standard_normal((d, d)) * 0.1).astype(np.float32),
            "bias": (rng.standard_normal(d) * 0.05).astype(np.float32)}
        for k in ("w_q", "w_k", "w_v")
    }
    pp = {
        "att_fc1": {"kernel": (rng.standard_normal((d, q)) * 0.1).astype(np.float32),
                    "bias": (rng.standard_normal(q) * 0.05).astype(np.float32)},
        "att_fc2": {"kernel": (rng.standard_normal((q, 1)) * 0.1).astype(np.float32),
                    "bias": np.zeros((1,), np.float32)},
    }
    return ap, pp


def _weights(ap, pp) -> UserTowerWeights:
    t = torch.from_numpy
    return UserTowerWeights(
        t(ap["w_q"]["kernel"]), t(ap["w_q"]["bias"]),
        t(ap["w_k"]["kernel"]), t(ap["w_k"]["bias"]),
        t(ap["w_v"]["kernel"]), t(ap["w_v"]["bias"]),
        t(pp["att_fc1"]["kernel"]), t(pp["att_fc1"]["bias"]),
        t(np.ascontiguousarray(pp["att_fc2"]["kernel"][:, 0])),
    )


def _jax_tree(tree):
    return {k: {kk: jnp.asarray(v) for kk, v in sub.items()} for k, sub in tree.items()}


def _dense_hist_score(x, cand, mask, ap, pp, nh):
    """The module chain on raw params in numpy float64 (stable softmax,
    mask after exp, +1e-8), an order-free reference for both frameworks."""
    b, h, d = x.shape
    dh = d // nh
    x = x.astype(np.float64)

    def mn(lg, m):
        w = np.exp(lg - lg.max(-1, keepdims=True)) * m
        return w / (w.sum(-1, keepdims=True) + 1e-8)

    q, k, v = ((x @ ap[n]["kernel"] + ap[n]["bias"]).reshape(b, h, nh, dh)
               for n in ("w_q", "w_k", "w_v"))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
    a = mn(s, mask[:, None, None, :])
    ctx = np.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, h, d)
    e = np.tanh(ctx @ pp["att_fc1"]["kernel"] + pp["att_fc1"]["bias"])
    al = mn((e @ pp["att_fc2"]["kernel"])[..., 0], mask)
    user = np.einsum("bh,bhd->bd", al, ctx)
    return np.einsum("bcd,bd->bc", cand, user), user


def test_fused_history_score_plain_matches_jax_kernel_and_dense_f32(rng):
    b, h, d, nh, c, q = 5, 7, 32, 4, 5, 16
    x = rng.standard_normal((b, h, d)).astype(np.float32)
    cand = rng.standard_normal((b, c, d)).astype(np.float32)
    mask = (rng.random((b, h)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[3] = 0.0  # a fully-masked history row pools to ~0
    ap, pp = _user_params(rng, d, q)
    sj, uj = jax_fused_history_score(
        jnp.asarray(x), jnp.asarray(cand), jnp.asarray(mask), _jax_tree(ap), _jax_tree(pp), nh
    )
    t = torch.from_numpy
    sp, up = fused_history_score_plain(t(x), t(cand), t(mask), _weights(ap, pp), nh)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(up.numpy(), np.asarray(uj), atol=1e-5)
    sd, ud = _dense_hist_score(x, cand, mask, ap, pp, nh)
    np.testing.assert_allclose(sp.numpy(), sd, atol=1e-5)
    np.testing.assert_allclose(up.numpy(), ud, atol=1e-5)
    assert np.abs(up.numpy()[3]).max() < 1e-6


def test_fused_history_score_plain_bf16_in_jax_kernel_band(rng):
    b, h, d, nh, c, q = 4, 7, 40, 4, 5, 16
    x = rng.standard_normal((b, h, d)).astype(np.float32)
    cand = rng.standard_normal((b, c, d)).astype(np.float32)
    mask = (rng.random((b, h)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    ap, pp = _user_params(rng, d, q)
    sj, uj = jax_fused_history_score(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cand, jnp.bfloat16),
        jnp.asarray(mask), _jax_tree(ap), _jax_tree(pp), nh,
    )
    t = torch.from_numpy
    sp, up = fused_history_score(
        t(x).to(torch.bfloat16), t(cand).to(torch.bfloat16), t(mask), _weights(ap, pp), nh
    )
    assert sp.dtype == torch.bfloat16 and up.dtype == torch.bfloat16
    np.testing.assert_allclose(
        sp.float().numpy(), np.asarray(sj.astype(jnp.float32)), atol=0.15, rtol=0.05
    )
    np.testing.assert_allclose(
        up.float().numpy(), np.asarray(uj.astype(jnp.float32)), atol=0.15, rtol=0.05
    )


def test_fused_user_vector_matches_jax_and_counts_no_launch_on_cpu(rng):
    b, h, d, nh, q = 3, 7, 32, 4, 16
    x = rng.standard_normal((2, b, h, d)).astype(np.float32)  # extra leading dim
    ap, pp = _user_params(rng, d, q)
    want = np.asarray(jax_fused_user_vector(jnp.asarray(x), None, _jax_tree(ap), _jax_tree(pp), nh))
    reset_launch_counts()
    got = fused_user_vector(torch.from_numpy(x), None, _weights(ap, pp), nh)
    assert got.shape == (2, b, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert set(launch_counts().values()) == {0} and len(launch_counts()) == 9


def test_additive_pool_grads_match_jax(rng):
    x, w1, b1, w2 = _pool_inputs(rng)
    mask = _mask(rng, "partial", *x.shape[:2])

    def jloss(x, w1, b1, w2):
        return jnp.sum(jax_additive_pool(x, w1, b1, w2, jnp.asarray(mask)) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, w1, b1, w2)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2)]
    out = additive_pool(*leaves, torch.from_numpy(mask))
    got = torch.autograd.grad(out.square().sum(), leaves)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), atol=1e-5)


def _head_params(rng, dh, ah, d):
    return {
        "pool": {
            "att_fc1": {"kernel": (rng.standard_normal((dh, ah)) * 0.1).astype(np.float32),
                        "bias": (rng.standard_normal(ah) * 0.1).astype(np.float32)},
            "att_fc2": {"kernel": (rng.standard_normal((ah, 1)) * 0.1).astype(np.float32),
                        "bias": np.zeros((1,), np.float32)},
        },
        "fc": {"kernel": (rng.standard_normal((dh, d)) * 0.1).astype(np.float32),
               "bias": (rng.standard_normal(d) * 0.1).astype(np.float32)},
    }


def _head_weights(p) -> TextHeadWeights:
    t = torch.from_numpy
    return TextHeadWeights(
        t(p["pool"]["att_fc1"]["kernel"]), t(p["pool"]["att_fc1"]["bias"]),
        t(np.ascontiguousarray(p["pool"]["att_fc2"]["kernel"][:, 0])),
        t(p["fc"]["kernel"]), t(p["fc"]["bias"]),
    )


def _jax_head(p):
    return jtu.tree_map(jnp.asarray, p)


@pytest.mark.parametrize("n,t,dh,ah,d,u", [(32, 12, 48, 24, 40, 16), (10, 7, 36, 18, 24, 5)])
def test_fused_gather_encode_plain_matches_jax_kernel(rng, n, t, dh, ah, d, u):
    table = rng.standard_normal((n, t, dh)).astype(np.float32)
    uniq = rng.integers(0, n, (u,))
    p = _head_params(rng, dh, ah, d)
    want = np.asarray(jax_fused_gather_encode(jnp.asarray(table), jnp.asarray(uniq, jnp.int32), _jax_head(p)))
    tt = torch.from_numpy(table)
    got = fused_gather_encode_plain(tt, torch.from_numpy(uniq), _head_weights(p))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # the public wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(fused_gather_encode(tt, torch.from_numpy(uniq), _head_weights(p)).numpy(),
                                  got.numpy())


def test_fused_gather_encode_grads_match_jax_kernel(rng):
    n, t, dh, ah, d, u = 24, 10, 32, 16, 20, 12
    table = rng.standard_normal((n, t, dh)).astype(np.float32)
    uniq = rng.integers(0, n, (u,))
    p = _head_params(rng, dh, ah, d)
    g = rng.standard_normal((u, d)).astype(np.float32)
    jt, ju = jnp.asarray(table), jnp.asarray(uniq, jnp.int32)
    _, vjp = jax.vjp(lambda pp: jax_fused_gather_encode(jax.lax.stop_gradient(jt), ju, pp), _jax_head(p))
    (gj,) = vjp(jnp.asarray(g))
    want = [gj["pool"]["att_fc1"]["kernel"], gj["pool"]["att_fc1"]["bias"],
            gj["pool"]["att_fc2"]["kernel"][:, 0], gj["fc"]["kernel"], gj["fc"]["bias"]]
    np.testing.assert_allclose(np.asarray(gj["pool"]["att_fc2"]["bias"]), 0.0)
    got = fused_gather_encode_bwd(torch.from_numpy(table), torch.from_numpy(uniq), _head_weights(p),
                                  torch.from_numpy(g))
    for name, a, b in zip(TextHeadWeights._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


def test_fused_gather_encode_bf16_in_jax_kernel_band(rng):
    n, t, dh, ah, d, u = 24, 10, 128, 64, 32, 12
    table = rng.standard_normal((n, t, dh)).astype(np.float32)
    uniq = rng.integers(0, n, (u,))
    p = _head_params(rng, dh, ah, d)
    want = jax_fused_gather_encode(jnp.asarray(table, jnp.bfloat16), jnp.asarray(uniq, jnp.int32), _jax_head(p))
    got = fused_gather_encode(torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(uniq),
                              _head_weights(p))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=0.15, rtol=0.05)


def test_fused_history_score_grads_match_jax_kernel(rng):
    b, h, d, nh, c, q = 4, 9, 24, 3, 3, 12
    x = rng.standard_normal((b, h, d)).astype(np.float32)
    cand = rng.standard_normal((b, c, d)).astype(np.float32)
    mask = (rng.random((b, h)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    ap, pp = _user_params(rng, d, q)
    gs = rng.standard_normal((b, c)).astype(np.float32)
    gu = rng.standard_normal((b, d)).astype(np.float32)

    def jf(x, cand, ap, pp):
        return jax_fused_history_score(x, cand, jnp.asarray(mask), ap, pp, nh)

    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(cand), _jax_tree(ap), _jax_tree(pp))
    gx, gc, gap, gpp = vjp((jnp.asarray(gs), jnp.asarray(gu)))
    np.testing.assert_allclose(np.asarray(gpp["att_fc2"]["bias"]), 0.0)
    t = torch.from_numpy
    dx, dcand, dw = fused_history_score_bwd(t(x), t(cand), t(mask), _weights(ap, pp), t(gs), t(gu), nh)
    want = [gap[k][f] for k in ("w_q", "w_k", "w_v") for f in ("kernel", "bias")]
    want += [gpp["att_fc1"]["kernel"], gpp["att_fc1"]["bias"], gpp["att_fc2"]["kernel"][:, 0]]
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), atol=5e-5)
    np.testing.assert_allclose(dcand.numpy(), np.asarray(gc), atol=5e-5)
    for name, a, w in zip(UserTowerWeights._fields, dw, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-5, err_msg=name)
