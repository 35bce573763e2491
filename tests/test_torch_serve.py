"""Port parity for the serving slice (CPU): ``encode_all_news`` and the exact
scorer ``build_recommend_fn`` against the JAX package on one bridged
parameter tree, then the port's store / batcher / service in-process.

Both sides run the slice's configuration at a small width
(``fuse_hot_path`` and ``use_pallas`` on; the JAX kernels in interpret
mode). Tolerances: the news table at 2e-5 (f32, the same products summed
in another order); top-k scores at 1e-4, the serving contract's bar
(``tests/test_fused_hot_path.py`` top-k parity), and ids equal wherever
neighbouring scores are more than 1e-4 apart, since a closer pair may
swap under a different summation order.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.config import ModelConfig as JaxModelConfig
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.serve import build_recommend_fn as jax_build_recommend_fn
from fedrec_tpu.train.step import encode_all_news as jax_encode_all_news
from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax
from fedrec_tpu_torch.serve import _exclude_ids, build_recommend_fn
from fedrec_tpu_torch.serving import EmbeddingStore, MicroBatcher, ServingService, start_server
from fedrec_tpu_torch.train.step import encode_all_news

_KW = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16, bert_hidden=48,
           fuse_hot_path=True, use_pallas=True)
_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(5)
    jm = JaxNewsRecommender(JaxModelConfig(**_KW))
    toks = jnp.asarray(rng.standard_normal((4, 7, 48)), jnp.float32)
    his = jnp.asarray(rng.standard_normal((2, 6, 32)), jnp.float32)
    v = jm.init(jax.random.PRNGKey(1), toks, his[:, :3], his,
                method=JaxNewsRecommender.init_both_towers)
    tree = jax.tree_util.tree_map(np.asarray, v["params"])
    tm = NewsRecommender(ModelConfig(**_KW)).eval()
    from_flax(tm, tree)
    return jm, tree, tm


@pytest.fixture(scope="module")
def catalog(models):
    """A 61-news table from seeded token states, through both packages."""
    jm, tree, tm = models
    toks = np.random.default_rng(6).standard_normal((61, 7, 48)).astype(np.float32)
    want = np.array(jax_encode_all_news(jm, tree["text_head"], jnp.asarray(toks), chunk=16))
    got = encode_all_news(tm, torch.from_numpy(toks), chunk=16, device="cpu")
    return toks, want, got


def test_encode_all_news_matches_jax(catalog):
    _, want, got = catalog
    assert got.shape == (61, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _assert_topk_agree(ids, scores, want_ids, want_scores):
    np.testing.assert_array_equal(ids < 0, want_ids < 0)
    live = want_ids >= 0
    np.testing.assert_allclose(scores[live], want_scores[live], atol=_TOL)
    np.testing.assert_array_equal(scores[~live], want_scores[~live])
    # an id is pinned when its score is more than the tolerance from both neighbours
    gaps = np.abs(np.diff(want_scores, axis=1))
    inf = np.full((want_scores.shape[0], 1), np.inf)
    decided = (np.concatenate([inf, gaps], 1) > _TOL) & (np.concatenate([gaps, inf], 1) > _TOL)
    np.testing.assert_array_equal(ids[decided], want_ids[decided])


@pytest.mark.parametrize("case", ["plain", "odd_ids", "valid_mask", "keep_history"])
def test_build_recommend_fn_matches_jax(models, catalog, case):
    jm, tree, tm = models
    _, table, _ = catalog
    n = table.shape[0]
    rng = np.random.default_rng(7)
    hist = rng.integers(1, n, (5, 9)).astype(np.int32)
    hist[:, 6:] = 0                                  # 0-padded tails
    valid = None
    if case == "odd_ids":
        hist[0, 2], hist[1, 3], hist[2, 0] = -3, n + 4, -n  # ignored by the exclusion
    if case == "valid_mask":
        valid = rng.random(n) > 0.4
    kw = dict(top_k=7, exclude_history=case != "keep_history", valid_mask=valid)
    want_ids, want_scores = jax_build_recommend_fn(jm, **kw)(
        tree["user_encoder"], jnp.asarray(table), jnp.asarray(hist)
    )
    fn = build_recommend_fn(**kw, device="cpu")
    ids, scores = fn(tm.user_encoder, torch.from_numpy(table), torch.from_numpy(hist))
    assert ids.dtype == torch.int32 and scores.dtype == torch.float32
    _assert_topk_agree(ids.numpy(), scores.numpy(), np.asarray(want_ids), np.asarray(want_scores))
    if case == "valid_mask":
        assert not np.isin(ids.numpy(), np.flatnonzero(~valid)).any()
    if case != "keep_history":
        for row, h in zip(ids.numpy(), hist):
            assert not set(row.tolist()) & set(h[(h > 0) & (h < n)].tolist())
            assert 0 not in row


def test_build_recommend_fn_unfused_use_pallas_matches_jax(models, catalog):
    """The long-history route: the unfused user tower under use_pallas
    (flash attention, then the pool kernel) scoring 40-click histories."""
    _, tree, _ = models
    _, table, _ = catalog
    kw = dict(_KW, fuse_hot_path=False)
    jm = JaxNewsRecommender(JaxModelConfig(**kw))
    tm = NewsRecommender(ModelConfig(**kw)).eval()
    from_flax(tm, tree)
    rng = np.random.default_rng(8)
    hist = rng.integers(1, table.shape[0], (4, 40)).astype(np.int32)
    hist[1, 25:] = 0
    want_ids, want_scores = jax_build_recommend_fn(jm, top_k=7)(
        tree["user_encoder"], jnp.asarray(table), jnp.asarray(hist)
    )
    ids, scores = build_recommend_fn(top_k=7, device="cpu")(
        tm.user_encoder, torch.from_numpy(table), torch.from_numpy(hist)
    )
    _assert_topk_agree(ids.numpy(), scores.numpy(), np.asarray(want_ids), np.asarray(want_scores))


def test_tiny_catalog_fills_the_tail_with_minus_one(models, catalog):
    jm, tree, tm = models
    _, table, _ = catalog
    small = table[:6]
    hist = np.array([[1, 2, 3, 0], [5, 5, -1, 9]], np.int32)
    want_ids, want_scores = jax_build_recommend_fn(jm, top_k=10)(
        tree["user_encoder"], jnp.asarray(small), jnp.asarray(hist)
    )
    ids, scores = build_recommend_fn(top_k=10, device="cpu")(
        tm.user_encoder, torch.from_numpy(small), torch.from_numpy(hist)
    )
    assert ids.shape == (2, 6)  # k = min(top_k, N)
    np.testing.assert_array_equal((ids < 0).sum(1).numpy(), [4, 2])
    assert float(scores[0, -1]) == float(np.finfo(np.float32).min)
    _assert_topk_agree(ids.numpy(), scores.numpy(), np.asarray(want_ids), np.asarray(want_scores))


def test_exclude_ids_ignores_ids_out_of_range():
    invalid = torch.zeros((2, 5), dtype=torch.bool)
    ids = torch.tensor([[-1, 2, 2], [5, -5, 4]])
    got = _exclude_ids(invalid, ids, 5)
    want = torch.tensor([[0, 0, 1, 0, 0], [0, 0, 0, 0, 1]], dtype=torch.bool)
    assert torch.equal(got, want)


def _service(models, catalog, **kw):
    _, _, tm = models
    _, table, _ = catalog
    store = EmbeddingStore()
    store.publish(torch.from_numpy(table), tm.user_encoder, source="synthetic")
    return ServingService(store, history_len=9, top_k=5, batch_sizes=(1, 4, 8),
                          device="cpu", **kw)


def test_serving_service_handle_and_tcp_round_trip(models, catalog):
    svc = _service(models, catalog)
    svc.warmup()
    hist = [3, 17, 40]
    want_ids, _ = build_recommend_fn(top_k=5, device="cpu")(
        svc.store.current().user_params, svc.store.current().news_vecs,
        torch.tensor([hist + [0] * 6]),
    )

    async def drive():
        server = await start_server(svc, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        reqs = [{"id": 1, "history": hist}, {"id": 2, "history": hist, "top_k": 2},
                {"cmd": "metrics"}, {"cmd": "nope"}]
        out = []
        for r in reqs:  # one at a time: a metrics request could overtake scoring
            writer.write((json.dumps(r) + "\n").encode())
            await writer.drain()
            out.append(json.loads(await reader.readline()))
        writer.write(b"not json\n")
        await writer.drain()
        out.append(json.loads(await reader.readline()))
        writer.close()
        server.close()
        await server.wait_closed()
        await svc.stop()
        return out

    r1, r2, metrics, unknown, bad = asyncio.run(drive())
    assert r1["id"] == 1 and r1["generation"] == 0 and r1["deadline_met"]
    assert r1["ids"] == want_ids[0].tolist()
    assert all(a >= b for a, b in zip(r1["scores"], r1["scores"][1:]))
    assert r2["ids"] == r1["ids"][:2]
    m = metrics["metrics"]
    assert m["served"] == 2 and m["generation"] == 0 and m["num_news"] == 61
    assert unknown == {"error": "unknown_cmd: nope"}
    assert bad == {"error": "bad_json"}


def test_micro_batcher_pads_to_the_smallest_bucket():
    seen = []

    def score(hist):
        seen.append(hist.copy())
        b = hist.shape[0]
        return np.tile(np.arange(3, dtype=np.int32), (b, 1)), np.zeros((b, 3), np.float32), 4

    async def drive():
        mb = MicroBatcher(score, history_len=4, batch_sizes=(1, 4, 8), flush_ms=50.0)
        await mb.start()
        res = await asyncio.gather(*(mb.submit([i + 1, 7, 8, 9, 10]) for i in range(3)))
        await mb.stop()
        return res, mb.metrics()

    res, metrics = asyncio.run(drive())
    assert [h.shape for h in seen] == [(4, 4)]
    np.testing.assert_array_equal(seen[0][:3], [[7, 8, 9, 10]] * 3)  # most recent 4 clicks
    np.testing.assert_array_equal(seen[0][3], 0)                      # the pad row
    assert {(r.batch_size, r.occupancy, r.generation) for r in res} == {(4, 0.75, 4)}
    assert metrics["batches_by_size"] == {1: 0, 4: 1, 8: 0}
