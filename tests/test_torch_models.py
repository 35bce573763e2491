"""Port parity for the models (CPU): one JAX ``NewsRecommender.init`` tree,
bridged with ``params.from_flax``, drives both packages on the same seeded
numpy inputs. Covers ``encode_news`` (dense and pool-kernel route),
``encode_user`` (dense and fused route) and the scoring forward.

f32 tolerance 2e-5: the two frameworks sum the same products in different
orders (reductions of length <= 48, values O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.config import ModelConfig as JaxModelConfig
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax, init_params

_KW = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16, bert_hidden=48)
_ATOL = 2e-5


@pytest.fixture(scope="module")
def flax_tree():
    rng = np.random.default_rng(3)
    model = JaxNewsRecommender(JaxModelConfig(**_KW))
    toks = jnp.asarray(rng.standard_normal((4, 7, 48)), jnp.float32)
    cand = jnp.asarray(rng.standard_normal((2, 3, 32)), jnp.float32)
    his = jnp.asarray(rng.standard_normal((2, 6, 32)), jnp.float32)
    v = model.init(jax.random.PRNGKey(0), toks, cand, his,
                   method=JaxNewsRecommender.init_both_towers)
    tree = jax.tree_util.tree_map(np.asarray, v["params"])
    # give the biases (zero at init) values, so the bridge is tested on them
    for i, path in enumerate(sorted(_bias_paths(tree))):
        node = tree
        for k in path:
            node = node[k]
        node["bias"] = np.random.default_rng(i).standard_normal(node["bias"].shape).astype(np.float32) * 0.05
    return tree


def _bias_paths(tree, prefix=()):
    if "bias" in tree:
        yield prefix
        return
    for k, sub in tree.items():
        yield from _bias_paths(sub, prefix + (k,))


def test_from_flax_maps_every_dense(flax_tree):
    tm = NewsRecommender(ModelConfig(**_KW))
    loaded = set(from_flax(tm, flax_tree))
    assert loaded == {
        "user_encoder.self_attn.w_q", "user_encoder.self_attn.w_k", "user_encoder.self_attn.w_v",
        "user_encoder.pool.att_fc1", "user_encoder.pool.att_fc2",
        "text_head.pool.att_fc1", "text_head.pool.att_fc2", "text_head.fc",
    }
    k = flax_tree["user_encoder"]["pool"]["att_fc2"]["kernel"]
    assert k.shape == (16, 1)
    np.testing.assert_array_equal(tm.user_encoder.pool.att_fc2.weight.detach().numpy(), k.T)
    with pytest.raises(ValueError):
        bad = {"text_head": {"fc": {"kernel": np.zeros((3, 3), np.float32),
                                    "bias": np.zeros(3, np.float32)}}}
        from_flax(tm, bad)
    with pytest.raises(KeyError):
        from_flax(tm, {"nope": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)}})


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encode_news_matches_jax(flax_tree, use_pallas):
    rng = np.random.default_rng(1)
    toks = rng.standard_normal((5, 7, 48)).astype(np.float32)
    mask = (rng.random((5, 7)) > 0.3).astype(np.float32)
    mask[1] = 0.0
    jm = JaxNewsRecommender(JaxModelConfig(**_KW, use_pallas=use_pallas))
    tm = NewsRecommender(ModelConfig(**_KW, use_pallas=use_pallas)).eval()
    from_flax(tm, flax_tree)
    v = {"params": flax_tree}
    for m in (None, mask):
        want = jm.apply(v, jnp.asarray(toks), None if m is None else jnp.asarray(m),
                        method=JaxNewsRecommender.encode_news)
        with torch.no_grad():
            got = tm.encode_news(torch.from_numpy(toks), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)


@pytest.mark.parametrize("fuse", [False, True])
def test_encode_user_and_forward_match_jax(flax_tree, fuse):
    rng = np.random.default_rng(2)
    his = rng.standard_normal((3, 6, 32)).astype(np.float32)
    cand = rng.standard_normal((3, 5, 32)).astype(np.float32)
    mask = (rng.random((3, 6)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    jm = JaxNewsRecommender(JaxModelConfig(**_KW, fuse_hot_path=fuse))
    tm = NewsRecommender(ModelConfig(**_KW, fuse_hot_path=fuse)).eval()
    from_flax(tm, flax_tree)
    v = {"params": flax_tree}
    t = torch.from_numpy
    with torch.no_grad():
        for m in (None, mask):
            want = jm.apply(v, jnp.asarray(his), None if m is None else jnp.asarray(m),
                            method=JaxNewsRecommender.encode_user)
            got = tm.encode_user(t(his), None if m is None else t(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)
        want = jm.apply(v, jnp.asarray(cand), jnp.asarray(his), jnp.asarray(mask))
        got = tm(t(cand), t(his), t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)


def test_fused_and_dense_routes_agree_and_cache_tracks_updates(flax_tree):
    rng = np.random.default_rng(4)
    his = torch.from_numpy(rng.standard_normal((2, 6, 32)).astype(np.float32))
    dense = NewsRecommender(ModelConfig(**_KW)).eval()
    fused = NewsRecommender(ModelConfig(**_KW, fuse_hot_path=True)).eval()
    from_flax(dense, flax_tree)
    from_flax(fused, flax_tree)
    with torch.no_grad():
        np.testing.assert_allclose(
            fused.encode_user(his).numpy(), dense.encode_user(his).numpy(), atol=_ATOL
        )
        # an in-place parameter update must reach the packed kernel weights
        for m in (dense, fused):
            m.user_encoder.self_attn.w_v.weight.mul_(2.0)
        np.testing.assert_allclose(
            fused.encode_user(his).numpy(), dense.encode_user(his).numpy(), atol=_ATOL
        )


def test_init_params_is_seeded_and_flax_shaped():
    a = init_params(NewsRecommender(ModelConfig(**_KW)), seed=5)
    b = init_params(NewsRecommender(ModelConfig(**_KW)), seed=5)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert torch.count_nonzero(a.text_head.fc.bias) == 0
    w = a.user_encoder.self_attn.w_q.weight.detach()
    bound = float(np.sqrt(6.0 / (w.shape[0] + w.shape[1])))  # xavier-uniform
    assert float(w.abs().max()) <= bound
