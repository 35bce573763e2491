"""Port parity for the long-history user tower's attention (CPU): the flash
kernels' plain versions, the autograd function around kernels F1-F3, the
chunked loop, and ``MultiHeadAttention`` / the unfused ``UserEncoder`` on
each route, against the JAX package (its Pallas kernels in interpret mode).

Tolerances. f32, the same products summed in another order: outputs 2e-5
and the log-sum-exp 1e-5 (values O(1-10)); gradients 1e-4 where the JAX
tests hold the blocked backward to the dense one (``tests/test_ops.py``),
3e-5 through the chunked loop and the modules. bf16: the JAX test's band,
0.05 against the f32 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.models.attention import MultiHeadAttention as JaxMultiHeadAttention
from fedrec_tpu.models.encoders import UserEncoder as JaxUserEncoder
from fedrec_tpu.ops.attention_kernels import _attention_dense, _flash, _flash_forward
from fedrec_tpu.ops.attention_kernels import flash_attention as jax_flash_attention
from fedrec_tpu.ops.chunked_attention import chunked_attention as jax_chunked_attention
from fedrec_tpu_torch.models.attention import MultiHeadAttention
from fedrec_tpu_torch.models.encoders import UserEncoder
from fedrec_tpu_torch.ops import (
    attention_kernels,
    chunked_attention,
    flash_attention,
    flash_backward_dkv_plain,
    flash_backward_dq_plain,
    flash_backward_plain,
    flash_forward_plain,
    launch_counts,
    reset_launch_counts,
)
from fedrec_tpu_torch.params import from_flax

t = torch.from_numpy


def _qkv(rng, *shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _mask(rng, b, L, fully_masked_row=False):
    m = (rng.random((b, L)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if fully_masked_row:
        m[1] = 0.0
    return m


def _bias(mask, h):
    """The wrappers' (B*H, L) key bias of a (B, L) mask."""
    return np.repeat(np.where(mask > 0, 0.0, -1e9), h, axis=0).astype(np.float32)


def _flat(x):
    """(B, L, H, d) -> (B*H, L, d), as the wrappers flatten."""
    b, L, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, L, d))


def _jax_out_and_grads(apply, params, g, *args):
    """``apply(params, *args)`` and the gradients of ``sum(out * g)`` in
    its parameters and arguments, in one jit."""
    def loss(p, *a):
        out = apply(p, *a)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args) + 1)),
                                                 has_aux=True))(params, *args)
    return out, grads


# ------------------------------------------------ kernel plain versions
@pytest.mark.parametrize("L,h,dk", [(50, 20, 20), (33, 4, 8), (130, 2, 64)])
def test_flash_forward_plain_matches_jax(rng, L, h, dk):
    q, k, v = (_flat(a) for a in _qkv(rng, 2, L, h, dk))
    bias = np.zeros((2 * h, L), np.float32)
    out, lse = _flash_forward(*(jnp.asarray(a) for a in (q, k, v, bias)), 32, 64)
    got_out, got_lse = flash_forward_plain(t(q), t(k), t(v), t(bias))
    assert got_out.dtype == torch.float32 and got_lse.shape == (2 * h, L)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5)


def test_flash_attention_key_mask_and_fully_masked_row_match_jax(rng):
    B, L, h, dk = 3, 24, 2, 16
    q, k, v = _qkv(rng, B, L, h, dk)
    mask = _mask(rng, B, L, fully_masked_row=True)
    want = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), block_q=16, block_k=16)
    reset_launch_counts()
    got = flash_attention(t(q), t(k), t(v), t(mask), block_q=16, block_k=16)
    assert got.shape == (B, L, h, dk) and set(launch_counts().values()) == {0}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert float(got[1].abs().max()) == 0.0  # no valid key: the row returns 0


@pytest.mark.parametrize("L,h,dk", [(50, 4, 20), (37, 2, 8)])
def test_flash_backward_plain_matches_jax_vjp(rng, L, h, dk):
    """dq, dk, dv and dbias at a ragged length with a key mask, against
    jax.vjp of the JAX flash (its blocked backward kernels)."""
    B = 2
    q, k, v = (_flat(a) for a in _qkv(rng, B, L, h, dk))
    bias = _bias(_mask(rng, B, L), h)
    g = rng.standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _flash(*a, 32, 16), *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    out, lse = flash_forward_plain(t(q), t(k), t(v), t(bias))
    got = flash_backward_plain(t(q), t(k), t(v), t(bias), out, lse, t(g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


def test_flash_attention_bf16_band(rng):
    """bf16 operands: the port and the JAX kernel both track the f32 dense
    reference within the JAX test's bf16 band."""
    B, L, h, dk = 2, 40, 4, 20
    q, k, v = _qkv(rng, B, L, h, dk)
    mask = (rng.random((B, L)) > 0.2).astype(np.float32)
    bias = _bias(mask, h)
    want = _attention_dense(*(jnp.asarray(_flat(a)) for a in (q, k, v)), jnp.asarray(bias))
    want = np.asarray(want).reshape(B, h, L, dk).transpose(0, 2, 1, 3)
    bf = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_attention(*bf, t(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05)
    jax_bf = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_bf, np.float32), atol=0.05)


def test_flash_autograd_function_routes_gradients(monkeypatch, rng):
    """The autograd function around kernels F1-F3, driven on CPU tensors
    with its three launchers swapped for the plain versions: the gradients
    are the plain backward's, dbias included."""
    monkeypatch.setattr(attention_kernels, "_launch_flash_fwd", flash_forward_plain)
    monkeypatch.setattr(attention_kernels, "_launch_flash_dq", flash_backward_dq_plain)
    monkeypatch.setattr(attention_kernels, "_launch_flash_dkv", flash_backward_dkv_plain)
    B, L, h, dk = 2, 21, 2, 8
    q, k, v = (_flat(a) for a in _qkv(rng, B, L, h, dk))
    bias = _bias(_mask(rng, B, L), h)
    g = rng.standard_normal(q.shape).astype(np.float32)
    leaves = [t(a).requires_grad_() for a in (q, k, v, bias)]
    out, _ = attention_kernels._Flash.apply(*leaves)
    got = torch.autograd.grad(out, leaves, t(g))
    ref_out, lse = flash_forward_plain(*(t(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(out.detach().numpy(), ref_out.numpy(), atol=1e-7)
    # the plain backward, which test_flash_backward_plain_matches_jax_vjp pins to JAX
    for a, b in zip(got, flash_backward_plain(*(t(a) for a in (q, k, v, bias)), ref_out, lse, t(g))):
        assert torch.equal(a, b)
    # only what is asked for: no dbias, no F3 work for a q-only gradient
    leaves = [t(q).requires_grad_(), t(k), t(v), t(bias)]
    (dq,) = torch.autograd.grad(attention_kernels._Flash.apply(*leaves)[0], leaves[:1], t(g))
    assert torch.equal(dq, got[0])


def test_chunked_attention_matches_jax(rng):
    B, L, h, dk = 2, 70, 3, 8
    q, k, v = _qkv(rng, B, L, h, dk)
    mask = _mask(rng, B, L, fully_masked_row=True)
    g = rng.standard_normal(q.shape).astype(np.float32)
    want, (_, *jgrads) = _jax_out_and_grads(
        lambda _, *a: jax_chunked_attention(*a, jnp.asarray(mask), 16, 32), jnp.zeros(()), g,
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    got = chunked_attention(*leaves, t(mask), 16, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    grads = torch.autograd.grad(got, leaves, t(g))
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, err_msg=f"d{name}")


# ------------------------------------------------------------- modules
def _mha_pair(impl, use_pallas=False, threshold=1024, d_in=24, h=3, dk=8):
    jm = JaxMultiHeadAttention(num_heads=h, head_dim=dk, use_pallas=use_pallas,
                               attn_impl=impl, chunk_threshold=threshold)
    tm = MultiHeadAttention(d_in, h, dk, use_pallas=use_pallas, attn_impl=impl,
                            chunk_threshold=threshold)
    return jm, tm


@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
def test_multi_head_attention_routes_match_jax(rng, impl):
    B, L, d_in = 2, 19, 24
    x = rng.standard_normal((B, L, d_in)).astype(np.float32)
    mask = _mask(rng, B, L)
    jm, tm = _mha_pair(impl)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), *(jnp.asarray(x),) * 3)["params"])
    from_flax(tm, params)
    g = rng.standard_normal((B, L, 24)).astype(np.float32)
    want, (jg_p, jg_x) = _jax_out_and_grads(
        lambda p, xx: jm.apply({"params": p}, xx, xx, xx, jnp.asarray(mask)), params, g,
        jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = tm(xt, xt, xt, t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), atol=3e-5)
    for name in ("w_q", "w_k", "w_v"):
        layer = getattr(tm, name)
        np.testing.assert_allclose(layer.weight.grad.numpy().T, np.asarray(jg_p[name]["kernel"]),
                                   atol=3e-5, err_msg=name)


@pytest.mark.parametrize("use_pallas,impl", [(True, "auto"), (False, "chunked"), (False, "dense")])
def test_unfused_user_encoder_matches_jax(rng, use_pallas, impl):
    """The unfused user tower: flash attention and the pool kernel under
    use_pallas (auto resolves to the kernels), or the chunked / dense
    routes; from_flax weights, outputs and weight gradients at 3e-5."""
    B, H, D = 3, 17, 32
    kw = dict(news_dim=D, num_heads=4, head_dim=8, query_dim=16, dropout_rate=0.0)
    jm = JaxUserEncoder(**kw, use_pallas=use_pallas, attn_impl=impl)
    tm = UserEncoder(**kw, use_pallas=use_pallas, attn_impl=impl)
    his = rng.standard_normal((B, H, D)).astype(np.float32)
    mask = _mask(rng, B, H)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(2), jnp.asarray(his))["params"])
    from_flax(tm, params)
    g = rng.standard_normal((B, D)).astype(np.float32)
    want, (jgrads,) = _jax_out_and_grads(
        lambda p: jm.apply({"params": p}, jnp.asarray(his), jnp.asarray(mask)), params, g)
    got = tm(t(his), t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=3e-5)
    (got * t(g)).sum().backward()
    for path, layer in (("self_attn.w_q", tm.self_attn.w_q), ("self_attn.w_v", tm.self_attn.w_v),
                        ("pool.att_fc1", tm.pool.att_fc1)):
        a, b = path.split(".")
        np.testing.assert_allclose(layer.weight.grad.numpy().T, np.asarray(jgrads[a][b]["kernel"]),
                                   atol=3e-5, err_msg=path)


def test_auto_resolves_as_jax_on_either_side_of_the_threshold(rng):
    """attn_impl="auto" off a TPU: pallas under use_pallas, else dense up to
    the threshold and chunked past it; both packages give the same output."""
    threshold = 8
    for use_pallas, L, route in ((False, 9, "chunked"), (True, 9, "pallas"), (True, 3, "pallas")):
        assert _mha_pair("auto", use_pallas, threshold)[1].resolve_impl(L) == route
    for use_pallas, L, route in ((False, 8, "dense"), (False, 9, "chunked")):
        jm, tm = _mha_pair("auto", use_pallas, threshold)
        assert tm.resolve_impl(L) == route
        x = rng.standard_normal((2, L, 24)).astype(np.float32)
        params = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(1), *(jnp.asarray(x),) * 3)["params"])
        from_flax(tm, params)
        want = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, xx, xx))(params, jnp.asarray(x))
        with torch.no_grad():
            got = tm(t(x), t(x), t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, err_msg=route)
    _, tm = _mha_pair("sparse")
    with pytest.raises(ValueError, match="attn_impl"):
        tm.resolve_impl(4)
