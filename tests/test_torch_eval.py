"""Port parity for evaluation (CPU): the host metrics, the device metrics
and the two eval steps against the JAX package (``fedrec_tpu.eval.metrics``,
``fedrec_tpu.train.step.build_eval_step`` / ``build_full_eval_step``).

Tolerances. The host metrics are numpy copies: equal to the bit. The device
metrics are closed forms of counts (ranks, pool sizes): on the same f32
scores they equal JAX's at 1e-7. The quality sums of weights (histograms,
counts) equal JAX's at 1e-7; the sums of scores and probabilities add the
same f32 values in another order, so they compare at rtol 1e-6. The eval
steps run the bridged model in each package: scores agree at 1e-5 (f32, the
same products summed in another order), and the per-impression metrics are
equal wherever the positive's margin to every negative exceeds 1e-4 — the
tests assert that margin on their seed, since a closer pair may swap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.config import ExperimentConfig as JaxExperimentConfig
from fedrec_tpu.data import make_synthetic_mind
from fedrec_tpu.eval import metrics as jm
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.train.step import build_eval_step as jax_build_eval_step
from fedrec_tpu.train.step import build_full_eval_step as jax_build_full_eval_step
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import TrainBatcher, index_samples
from fedrec_tpu_torch.eval import metrics as tm
from fedrec_tpu_torch.models import NewsRecommender, score_candidates
from fedrec_tpu_torch.params import init_params
from fedrec_tpu_torch.train import build_eval_step, build_full_eval_step, encode_all_news

_KW = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16, bert_hidden=48)
_MARGIN = 1e-4
_QUALITY = (12, 3.0, 8)


# ------------------------------------------------------------ host metrics
def _label_score_cases(rng):
    """(y_true, y_score) pairs: distinct scores, exact ties across the
    classes, several positives, and both one-class sets."""
    cases = []
    for n in (5, 9, 16):
        y = (rng.random(n) < 0.3).astype(np.int64)
        y[0], y[-1] = 1, 0
        cases.append((y, rng.standard_normal(n)))
        cases.append((y, np.round(rng.standard_normal(n), 1)))  # ties
        cases.append((y, np.zeros(n)))                            # all tied
    cases.append((np.ones(4, np.int64), rng.standard_normal(4)))
    cases.append((np.zeros(4, np.int64), rng.standard_normal(4)))
    return cases


def test_host_metrics_equal_jax(rng):
    for y, s in _label_score_cases(rng):
        one_class = y.min() == y.max()
        for k in (1, 5, 10):
            assert tm.dcg_score(y, s, k) == jm.dcg_score(y, s, k)
            if not one_class or y[0] == 1:
                assert tm.ndcg_score(y, s, k) == jm.ndcg_score(y, s, k)
        if y.sum() > 0:
            assert tm.mrr_score(y, s) == jm.mrr_score(y, s)
        if one_class:
            with pytest.raises(ValueError):
                tm.auc_score(y, s)
            assert np.isnan(tm.safe_auc_score(y, s)) and np.isnan(jm.safe_auc_score(y, s))
            continue
        assert tm.auc_score(y, s) == jm.auc_score(y, s)
        assert tm.safe_auc_score(y, s) == jm.safe_auc_score(y, s)
        assert tm.compute_amn(y, s) == jm.compute_amn(y, s)


def test_evaluation_split_equals_jax_and_skips_empty_pools(rng):
    news = rng.standard_normal((12, 6))
    users = rng.standard_normal((5, 6))
    nid2index = {f"N{i}": i for i in range(12)}
    samples = [
        [0, "N1", ["N2", "N3", "N4"], [], "U0"],
        [1, "N5", [], [], "U1"],                       # no negative: skipped
        [2, ["N6", "N7"], ["N8", "N9"], [], "U2"],      # two positives
        [3, "N10", ["N11"], [], "U3"],
        [4, "N2", ["N2", "N1", "N0"], [], "U4"],        # the positive's id among the negatives
    ]
    got = tm.evaluation_split(news, users, samples, nid2index)
    want = jm.evaluation_split(news, users, samples, nid2index)
    assert got.shape == want.shape == (4, 4)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- device metrics
def _scores(rng, shape):
    """f32 scores with exact ties (one decimal) and distinct values."""
    s = rng.standard_normal(shape).astype(np.float32)
    s[::2] = np.round(s[::2], 1)
    return s


def _close(got: dict, want: dict, keys, atol=1e-7, rtol=0.0):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("positive_index", [0, 2])
def test_ranking_metrics_batch_equals_jax(rng, positive_index):
    s = _scores(rng, (64, 5))
    s[:4, 1:] = s[:4, :1]  # the positive tied with every negative
    got = tm.ranking_metrics_batch(torch.from_numpy(s), positive_index)
    want = jm.ranking_metrics_batch(jnp.asarray(s), positive_index)
    _close(got, want, ("auc", "mrr", "ndcg5", "ndcg10"))


def _pools(rng, b=48, p=14):
    pos = _scores(rng, (b,))
    neg = _scores(rng, (b, p))
    lens = rng.integers(0, p + 1, size=b)
    lens[:3] = 0                                    # n_neg = 0 rows
    mask = (np.arange(p)[None, :] < lens[:, None]).astype(np.float32)
    neg[3, 0] = pos[3]                              # an exact tie with the positive
    return pos, neg, mask


def test_full_pool_metrics_batch_equals_jax(rng):
    pos, neg, mask = _pools(rng)
    got = tm.full_pool_metrics_batch(*map(torch.from_numpy, (pos, neg, mask)))
    want = jm.full_pool_metrics_batch(*map(jnp.asarray, (pos, neg, mask)))
    _close(got, want, ("auc", "mrr", "ndcg5", "ndcg10"))
    assert float(got["auc"][:3].abs().max()) == 0.0


def test_quality_stats_batch_equals_jax(rng):
    pos, neg, mask = _pools(rng)
    pos[5], neg[6, 0], neg[7, 1] = 40.0, -35.0, 3.0   # out of range: the edge bins
    pos[8], neg[9, 2] = np.nan, np.inf                # non-finite: masked out of bins
    keep = np.ones(pos.shape, np.float32)
    keep[-4:] = 0.0                                   # padded impressions
    got = tm.quality_stats_batch(*map(torch.from_numpy, (pos, neg, mask, keep)), *_QUALITY)
    want = jm.quality_stats_batch(*map(jnp.asarray, (pos, neg, mask, keep)), *_QUALITY)
    assert set(got) == set(want) == set(tm.QUALITY_SUM_KEYS) == set(jm.QUALITY_SUM_KEYS)
    counts = ("q.pos_hist", "q.neg_hist", "q.pos_n", "q.neg_n", "q.cal_n", "q.cal_label")
    _close(got, want, counts)
    _close(got, want, ("q.pos_sum", "q.pos_sq", "q.neg_sum", "q.neg_sq", "q.cal_conf"),
           rtol=1e-6)
    # finite inputs: the NaN and inf above poison the moment sums in both
    finite = np.isfinite(pos)
    clean = [a[finite] for a in (pos, neg, mask, keep)]
    clean[1] = np.nan_to_num(clean[1], posinf=0.0)
    got = tm.quality_stats_batch(*map(torch.from_numpy, clean), *_QUALITY)
    want = jm.quality_stats_batch(*map(jnp.asarray, clean), *_QUALITY)
    assert all(np.isfinite(got[k].numpy()).all() for k in got)
    _close(got, want, ("q.pos_sum", "q.pos_sq", "q.neg_sum", "q.neg_sq", "q.cal_conf"),
           rtol=1e-6)


# ---------------------------------------------------- eval steps vs JAX
def _to_flax(module) -> dict:
    tree: dict = {}
    for name, layer in module.named_modules():
        if isinstance(layer, torch.nn.Linear):
            node = tree
            for key in name.split("."):
                node = node.setdefault(key, {})
            node["kernel"] = jnp.asarray(layer.weight.detach().numpy().T)
            node["bias"] = jnp.asarray(layer.bias.detach().numpy())
    return tree


@pytest.fixture(scope="module")
def eval_setup():
    """Valid impressions (positives apart from negatives), token states and
    the port's news table through the slice's text head."""
    data = make_synthetic_mind(num_news=64, num_train=8, num_valid=40, title_len=12,
                               his_len_range=(2, 10), seed=4, popular_frac=0.2)
    ix = index_samples(data.valid_samples, data.nid2index, 10)
    toks = np.random.default_rng(4).standard_normal((64, 12, 48)).astype(np.float32)
    return ix, toks


def _models(fuse: bool):
    cfg = ExperimentConfig().apply_overrides(
        [f"model.{k}={v}" for k, v in _KW.items()]
        + [f"model.fuse_hot_path={fuse}", "model.use_pallas=true", "data.max_his_len=10"])
    model = init_params(NewsRecommender(cfg.model), seed=2).eval()
    jcfg = JaxExperimentConfig()
    for k, v in {**_KW, "fuse_hot_path": fuse, "use_pallas": True}.items():
        setattr(jcfg.model, k, v)
    return cfg, model, jcfg, JaxNewsRecommender(jcfg.model), _to_flax(model)


def _margins(pos: np.ndarray, neg: np.ndarray, mask: np.ndarray) -> float:
    gaps = np.where(mask > 0, np.abs(neg - pos[:, None]), np.inf)
    return float(gaps.min())


@pytest.mark.parametrize("fuse", [True, False])
def test_build_eval_step_matches_jax(eval_setup, fuse):
    ix, toks = eval_setup
    cfg, model, jcfg, jmodel, tree = _models(fuse)
    table = encode_all_news(model, torch.from_numpy(toks), device="cpu")
    vb = TrainBatcher(ix, batch_size=len(ix), npratio=4, shuffle=False, drop_remainder=False)
    b = next(vb.epoch_batches(0))
    batch = {"candidates": b.candidates, "history": b.history, "labels": b.labels}
    got = build_eval_step(cfg, device="cpu")(model.user_encoder, table, batch)
    want = jax_build_eval_step(jmodel, jcfg)(tree["user_encoder"], jnp.asarray(table.numpy()),
                                             batch)
    with torch.no_grad():
        his = table[torch.from_numpy(b.history).long()]
        s_port = score_candidates(table[torch.from_numpy(b.candidates).long()],
                                  model.user_encoder(his)).numpy()
    jt = jnp.asarray(table.numpy())
    juser = jmodel.apply({"params": {"user_encoder": tree["user_encoder"]}}, jt[b.history],
                         method=JaxNewsRecommender.encode_user)
    s_jax = np.asarray(jnp.einsum("bcd,bd->bc", jt[b.candidates], juser))
    np.testing.assert_allclose(s_port, s_jax, atol=1e-5)
    margin = _margins(s_port[:, 0], s_port[:, 1:], np.ones_like(s_port[:, 1:]))
    assert margin > _MARGIN, f"seed gives a margin of {margin}; the metric check needs {_MARGIN}"
    _close(got, want, ("auc", "mrr", "ndcg5", "ndcg10"))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=1e-6)


def _full_batch(ix, keep_pad: int = 0):
    p = ix.neg_pools.shape[1]
    mask = (np.arange(p)[None, :] < ix.neg_lens[:, None]).astype(np.float32)
    keep = np.ones(len(ix), np.float32)
    if keep_pad:
        keep[-keep_pad:] = 0.0
    return {"pos": ix.pos, "neg_pools": ix.neg_pools, "neg_mask": mask,
            "history": ix.history, "keep": keep}


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("quality", [None, _QUALITY], ids=["plain", "quality"])
def test_build_full_eval_step_matches_jax(eval_setup, fuse, quality):
    ix, toks = eval_setup
    cfg, model, jcfg, jmodel, tree = _models(fuse)
    table = encode_all_news(model, torch.from_numpy(toks), device="cpu")
    batch = _full_batch(ix, keep_pad=3)
    if quality is None:
        batch.pop("keep")
    got = build_full_eval_step(quality, device="cpu")(model.user_encoder, table, batch)
    jt = jnp.asarray(table.numpy())
    want = jax_build_full_eval_step(jmodel, jcfg, quality)(tree["user_encoder"], jt, batch)
    with torch.no_grad():
        user = model.user_encoder(table[torch.from_numpy(ix.history).long()])
        pos = torch.einsum("bd,bd->b", table[torch.from_numpy(ix.pos).long()], user).numpy()
        neg = torch.einsum("bpd,bd->bp", table[torch.from_numpy(ix.neg_pools).long()],
                           user).numpy()
    juser = jmodel.apply({"params": {"user_encoder": tree["user_encoder"]}}, jt[ix.history],
                         method=JaxNewsRecommender.encode_user)
    np.testing.assert_allclose(pos, np.asarray(jnp.einsum("bd,bd->b", jt[ix.pos], juser)),
                               atol=1e-5)
    np.testing.assert_allclose(neg, np.asarray(jnp.einsum("bpd,bd->bp", jt[ix.neg_pools],
                                                          juser)), atol=1e-5)
    margin = _margins(pos, neg, batch["neg_mask"])
    assert margin > _MARGIN, f"seed gives a margin of {margin}; the metric check needs {_MARGIN}"
    _close(got, want, ("auc", "mrr", "ndcg5", "ndcg10"))
    if quality is not None:
        _close(got, want, ("q.pos_hist", "q.neg_hist", "q.pos_n", "q.neg_n", "q.cal_n",
                           "q.cal_label"))
        # sums of scores that agree at 1e-5 each
        _close(got, want, ("q.pos_sum", "q.pos_sq", "q.neg_sum", "q.neg_sq", "q.cal_conf"),
               atol=1e-4, rtol=1e-5)


def test_eval_steps_refuse_a_table_on_another_device(eval_setup):
    ix, toks = eval_setup
    cfg, model, *_ = _models(True)
    step = build_full_eval_step(device="cpu")
    table = encode_all_news(model, torch.from_numpy(toks), device="cpu").to("meta")
    with pytest.raises(ValueError, match="news_vecs live on"):
        step(model.user_encoder, table, _full_batch(ix))
