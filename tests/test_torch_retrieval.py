"""Port parity for k-means two-stage retrieval (CPU): ``_lloyd`` from the
JAX package's own init rows against JAX ``kmeans``, the member table
against JAX ``build_index``'s, the two-stage scorer against JAX
``build_two_stage_fn`` on one bridged parameter tree and one index, recall
against brute force, and the exact fallback.

Tolerances: centroids at 1e-5 (f32 means of the same members, summed in
another order); two-stage scores at 1e-5 (the same f32 dot products of
one user vector, summed in another order), ids equal wherever neighbouring
scores are more than 1e-5 apart; the exact fallback bitwise equal to the
port's dense scorer, and the blocked rerank to the unblocked one. The user
tower runs the slice's configuration (``fuse_hot_path`` and ``use_pallas`` on; the JAX kernels in
interpret mode) at a small width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedrec_tpu_torch.serving.retrieval as retrieval
from fedrec_tpu.config import ModelConfig as JaxModelConfig
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.serving import build_index as jax_build_index
from fedrec_tpu.serving import build_two_stage_fn as jax_build_two_stage_fn
from fedrec_tpu.serving import kmeans as jax_kmeans
from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax
from fedrec_tpu_torch.serve import build_recommend_fn
from fedrec_tpu_torch.serving import (
    TwoStageIndex,
    build_index,
    build_two_stage_fn,
    kmeans,
    recall_at_k,
)
from fedrec_tpu_torch.serving.retrieval import _in_history, _lloyd, member_table, rerank_scores

_KW = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16, bert_hidden=32,
           fuse_hot_path=True, use_pallas=True)
_SCORE_TOL = 1e-5


def _jax_init_rows(n: int, c: int, seed: int) -> np.ndarray:
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (c,), replace=False))


def _blobs() -> np.ndarray:
    rng = np.random.default_rng(0)
    centers = np.array([[10, 0], [0, 10], [-10, -10]], np.float32)
    return np.concatenate([c + 0.1 * rng.standard_normal((40, 2)).astype(np.float32)
                           for c in centers])


def _clustered(n, d, num_centers, rng, spread=0.25):
    centers = rng.standard_normal((num_centers, d)).astype(np.float32) * 2.0
    which = rng.integers(0, num_centers, n)
    return (centers[which] + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["separated_blobs", "empty_clusters"])
def test_lloyd_from_jax_init_matches_jax_kmeans(case):
    if case == "separated_blobs":
        vecs, c, iters, seed = _blobs(), 3, 10, 1
    else:  # more clusters than structure: some empty, kept where they are
        vecs = np.random.default_rng(1).standard_normal((50, 8)).astype(np.float32)
        c, iters, seed = 16, 5, 0
    want_c, want_a = map(np.asarray, jax_kmeans(jnp.asarray(vecs), c, iters=iters, seed=seed))
    init = vecs[_jax_init_rows(vecs.shape[0], c, seed)]
    got_c, got_a = _lloyd(torch.from_numpy(vecs), torch.from_numpy(init), iters)
    assert got_c.dtype == torch.float32 and got_a.dtype == torch.int32
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), want_a)


def test_kmeans_repeats_bitwise_and_recovers_separated_clusters():
    vecs = torch.from_numpy(_blobs())
    c1, a1 = kmeans(vecs, 3, iters=10, seed=4, device="cpu")
    c2, a2 = kmeans(vecs, 3, iters=10, seed=4, device="cpu")
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    groups = [set(a1[i * 40:(i + 1) * 40].tolist()) for i in range(3)]
    assert all(len(g) == 1 for g in groups) and len(set().union(*groups)) == 3
    cents, assign = kmeans(torch.randn(50, 8, generator=torch.Generator().manual_seed(1)), 80,
                           iters=3, device="cpu")
    assert cents.shape == (50, 8) and assign.shape == (50,)  # clusters capped at N
    assert bool(torch.isfinite(cents).all())


@pytest.fixture(scope="module")
def big_setup():
    """A 10k-item clustered catalog (the JAX retrieval tests' own), one
    bridged parameter tree in both packages, 16 histories of 10 clicks."""
    rng = np.random.default_rng(4)
    n, d, h, b = 10_000, 32, 10, 16
    table = _clustered(n, d, num_centers=64, rng=rng)
    hist = rng.integers(1, n, (b, h)).astype(np.int32)
    hist[3, 6:] = 0
    jm = JaxNewsRecommender(JaxModelConfig(**_KW))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, h, d), jnp.float32),
                     method=JaxNewsRecommender.encode_user)["params"]["user_encoder"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = NewsRecommender(ModelConfig(**_KW)).eval()
    from_flax(tm.user_encoder, params)
    valid = rng.random(n) > 0.1
    return jm, params, tm.user_encoder, table, hist, valid


def test_member_table_matches_jax_build_index(big_setup):
    _, _, _, table, _, valid = big_setup
    index = jax_build_index(jnp.asarray(table), num_clusters=128, n_probe=8, iters=5,
                            valid_mask=valid, exact_threshold=1024)
    _, assign = jax_kmeans(jnp.asarray(table), 128, iters=5)
    got = member_table(np.asarray(assign), 128, valid)
    np.testing.assert_array_equal(got, np.asarray(index.members))
    assert not np.isin(got, np.flatnonzero(~valid)).any() and 0 not in got


def _port_index(jax_index, table, valid, n_probe) -> TwoStageIndex:
    return TwoStageIndex(news_vecs=torch.from_numpy(table), valid_mask=valid, exact=False,
                         centroids=torch.from_numpy(np.array(jax_index.centroids)),
                         members=torch.from_numpy(np.array(jax_index.members)).long(),
                         n_probe=n_probe)


@pytest.mark.parametrize("case", ["plain", "valid_mask", "keep_history", "full_probe"])
def test_two_stage_matches_jax_on_one_index(big_setup, case):
    jm, params, tower, table, hist, valid = big_setup
    mask = valid if case == "valid_mask" else None
    n_probe = 128 if case == "full_probe" else 16
    jindex = jax_build_index(jnp.asarray(table), num_clusters=128, n_probe=n_probe, iters=20,
                             valid_mask=mask, exact_threshold=1024)
    excl = case != "keep_history"
    want_ids, want_scores = map(np.asarray, jax_build_two_stage_fn(
        jm, jindex, top_k=10, exclude_history=excl)(params, jnp.asarray(hist)))
    fn = build_two_stage_fn(_port_index(jindex, table, mask, n_probe), top_k=10,
                            exclude_history=excl, device="cpu")
    ids, scores = fn(tower, torch.from_numpy(hist))
    assert ids.dtype == torch.int32 and ids.shape == (16, 10)
    ids, scores = ids.numpy(), scores.numpy()
    np.testing.assert_allclose(scores, want_scores, atol=_SCORE_TOL)
    gaps = np.abs(np.diff(want_scores, axis=1))
    inf = np.full((want_scores.shape[0], 1), np.inf)
    decided = ((np.concatenate([inf, gaps], 1) > _SCORE_TOL)
               & (np.concatenate([gaps, inf], 1) > _SCORE_TOL))
    np.testing.assert_array_equal(ids[decided], want_ids[decided])
    if excl:
        for row, h in zip(ids, hist):
            assert not set(row.tolist()) & set(h.tolist())


def test_recall_at_k_on_the_10k_catalog(big_setup):
    """recall@10 >= 0.95 at a sub-full scan, and exactly 1 with every
    cluster probed (then the rerank is brute force)."""
    _, _, tower, table, hist, _ = big_setup
    vecs = torch.from_numpy(table)
    recalls = {}
    for p in (1, 16, 128):
        index = build_index(vecs, num_clusters=128, n_probe=p, iters=20,
                            exact_threshold=1024, device="cpu")
        assert not index.exact
        recalls[p] = recall_at_k(index, tower, torch.from_numpy(hist), k=10, device="cpu")
    assert index.stats()["num_clusters"] == 128
    assert recalls[16] >= 0.95, recalls
    assert recalls[1] <= recalls[16] <= recalls[128] == 1.0, recalls


def test_exact_fallback_is_the_dense_scorer(big_setup):
    jm, params, tower, table, hist, _ = big_setup
    small = torch.from_numpy(table[:300])
    h = torch.from_numpy(np.clip(hist, 0, 299))
    valid = np.arange(300) < 200
    for mask in (None, valid):
        index = build_index(small, num_clusters=16, valid_mask=mask, exact_threshold=4096)
        assert index.exact and index.stats() == {"exact": True, "num_news": 300}
        ids, scores = build_two_stage_fn(index, top_k=7, device="cpu")(tower, h)
        want = build_recommend_fn(top_k=7, valid_mask=mask, device="cpu")(tower, small, h)
        assert torch.equal(ids, want[0]) and torch.equal(scores, want[1])
        jindex = jax_build_index(jnp.asarray(table[:300]), num_clusters=16, valid_mask=mask)
        jids, jscores = map(np.asarray, jax_build_two_stage_fn(jm, jindex, top_k=7)(
            params, jnp.asarray(h.numpy())))
        np.testing.assert_allclose(scores.numpy(), jscores, atol=1e-4)
        if mask is not None:
            assert bool(((ids > 0) & (ids < 200)).all())


def test_history_membership_equals_the_broadcast_compare():
    g = torch.Generator().manual_seed(3)
    cand = torch.randint(-1, 60, (5, 400), generator=g)
    hist = torch.randint(-2, 70, (5, 9), generator=g)
    want = (cand[:, :, None] == hist[:, None, :]).any(-1)
    assert torch.equal(_in_history(cand, hist), want)


def test_rerank_blocks_do_not_change_the_scores(monkeypatch):
    g = torch.Generator().manual_seed(5)
    vecs = torch.randn(500, 24, generator=g)
    user = torch.randn(6, 24, generator=g)
    cand = torch.randint(-1, 500, (6, 130), generator=g)
    whole = rerank_scores(user, vecs, cand)
    monkeypatch.setattr(retrieval, "_RERANK_BYTES", 4 * 24 * 6 * 7)  # 7 columns a block
    blocked = rerank_scores(user, vecs, cand)
    want = (vecs[cand.clamp(0, 499)] * user[:, None, :]).sum(-1)
    np.testing.assert_allclose(whole.numpy(), want.numpy(), atol=1e-5)
    assert torch.equal(whole, blocked)
