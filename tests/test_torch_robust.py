"""Port parity for robust aggregation (CPU): ``fed.robust.robust_aggregate``
against the JAX package's ``robust_aggregate``, driven through ``shard_map``
over 8 fake CPU devices as ``tests/test_robust.py`` drives it, for
trimmed_mean, median and clip, with poisoned, non-finite, non-participating
and absent clients; then ``build_param_sync``: ``mean`` bitwise the plain
weighted mean, ``clip``'s deviation norm global over both towers, and a
repeat bitwise equal.

Bar: rtol 1e-6 (and atol 1e-6 where values cross 0): the same f32 values,
sorted the same way, summed in another order.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.fed import get_strategy, weighted_param_avg
from fedrec_tpu_torch.fed.robust import ROBUST_METHODS, robust_aggregate, validate_robust_method
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import init_params
from fedrec_tpu_torch.train import build_param_sync, init_client_state, replicate_state

sys.path.insert(0, str(Path(__file__).parent))
from test_robust import _run_agg  # noqa: E402


def _port(vals: np.ndarray, weights: np.ndarray, method: str, **kw) -> np.ndarray:
    """Each client's aggregate of one (K, ...) leaf through the port."""
    params = [[torch.from_numpy(v.copy())] for v in vals]
    out = robust_aggregate(params, weights, method, **kw)
    return np.stack([o[0].numpy() for o in out])


def _fixture(name: str):
    rng = np.random.default_rng(0)
    w = np.ones((8,), np.float32)
    if name == "poison_x1000":
        honest = rng.standard_normal((3,)).astype(np.float32)
        vals = np.tile(honest, (8, 1))
        vals[5] = honest * 1000.0
    elif name == "distinct_extremes":
        vals = np.arange(16, dtype=np.float32).reshape(8, 2)
        vals[0] = [-1e6, 1e6]
    elif name == "random_poison":
        vals = rng.standard_normal((8, 5)).astype(np.float32)
        vals[2] *= 1000.0
    elif name == "nan_and_nonparticipant":
        vals = np.tile(np.arange(3, dtype=np.float32), (8, 1))
        vals[1] = np.nan
        vals[4] = 1e9
        w[4] = 0.0
    elif name == "even_participants":
        vals = rng.standard_normal((8, 4, 3)).astype(np.float32)
        w[[0, 3]] = 0.0
    elif name == "no_participants":
        vals = rng.standard_normal((8, 3)).astype(np.float32)
        w[:] = 0.0
    elif name == "nan_coordinate":
        vals = rng.standard_normal((8, 4)).astype(np.float32)
        vals[:, 2] = np.nan  # no finite value at one coordinate
    elif name == "weighted":
        vals = rng.standard_normal((8, 6)).astype(np.float32)
        w = np.array([1, 0, 2, 1, 3, 1, 1, 0.5], np.float32)
    else:
        raise KeyError(name)
    return vals, w


_FIXTURES = ["poison_x1000", "distinct_extremes", "random_poison", "nan_and_nonparticipant",
             "even_participants", "no_participants", "nan_coordinate", "weighted"]


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "clip"])
@pytest.mark.parametrize("fixture", _FIXTURES)
def test_robust_aggregate_matches_jax(fixture, method):
    vals, w = _fixture(fixture)
    kw = {"trim_k": 1} if method == "trimmed_mean" else {}
    if method == "clip":
        kw = {"clip_norm": 0.5}
    want = _run_agg(vals, w, method, **kw)
    got = _port(vals, w, method, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "clip"])
def test_trim_k_and_clip_norm_reach_the_aggregate(method):
    vals, w = _fixture("random_poison")
    kw = {"trim_k": 3} if method == "trimmed_mean" else {"clip_norm": 0.05}
    if method == "median":
        kw = {}
    np.testing.assert_allclose(_port(vals, w, method, **kw), _run_agg(vals, w, method, **kw),
                               rtol=1e-6, atol=1e-6)


def test_mean_is_bitwise_weighted_param_avg():
    vals, w = _fixture("weighted")
    params = [[torch.from_numpy(v.copy())] for v in vals]
    want = weighted_param_avg(params, w)
    got = robust_aggregate(params, w, "mean")
    assert all(torch.equal(a[0], b[0]) for a, b in zip(got, want))


def test_unknown_method_fails_fast_with_jax_wording():
    from fedrec_tpu.fed.robust import validate_robust_method as jax_validate

    with pytest.raises(ValueError) as want:
        jax_validate("krum")
    with pytest.raises(ValueError) as got:
        validate_robust_method("krum")
    assert str(got.value) == str(want.value)
    assert ROBUST_METHODS == ("mean", "clip", "trimmed_mean", "median")


# ------------------------------------------------------------ through the sync
def _diverged_states(method: str, k: int = 8):
    cfg = ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", f"fed.num_clients={k}", f"fed.robust.method={method}",
        "fed.robust.clip_norm=0.5"])
    model = init_params(NewsRecommender(cfg.model), seed=0)
    states = replicate_state(init_client_state(model, cfg, seed=0), k)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for c, st in enumerate(states):
            for p in st.model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
                if c == 3:
                    p.mul_(1000.0)
    return cfg, states


def test_clip_sync_spans_both_towers_at_once():
    """``clip`` measures each client's deviation as one global L2 over the
    user tower and the text head together: the sync equals JAX's clip over
    each client's concatenated parameter vector."""
    cfg, states = _diverged_states("clip")
    flat = np.stack([np.concatenate([p.detach().numpy().ravel()
                                     for p in st.user_params() + st.news_params()])
                     for st in states])
    w = np.ones(8, np.float32)
    w[6] = 0.0
    want = _run_agg(flat, w, "clip", clip_norm=0.5)[0]
    build_param_sync(cfg, get_strategy("param_avg"))(states, w)
    for st in states:
        got = np.concatenate([p.detach().numpy().ravel()
                              for p in st.user_params() + st.news_params()])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["trimmed_mean", "median"])
def test_coordinate_methods_sync_every_client(method):
    cfg, states = _diverged_states(method)
    before = [[p.detach().numpy().copy() for p in st.model.parameters()] for st in states]
    build_param_sync(cfg, get_strategy("param_avg"))(states, np.ones(8, np.float32))
    for i, leaf in enumerate(zip(*before)):
        srt = np.sort(np.stack(leaf).astype(np.float64), axis=0)
        want = srt[1:-1].mean(0) if method == "trimmed_mean" else np.median(srt, axis=0)
        for st in states:
            got = list(st.model.parameters())[i].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["mean", "clip", "trimmed_mean", "median"])
def test_sync_repeats_bitwise_and_keeps_locals_without_participants(method):
    outs = []
    for _ in range(2):
        cfg, states = _diverged_states(method)
        build_param_sync(cfg, get_strategy("param_avg"))(states, np.ones(8, np.float32))
        outs.append([p.detach().clone() for st in states for p in st.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    cfg, states = _diverged_states(method)
    before = [p.detach().clone() for st in states for p in st.model.parameters()]
    build_param_sync(cfg, get_strategy("param_avg"))(states, np.zeros(8, np.float32))
    after = [p.detach() for st in states for p in st.model.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_robust_methods_need_a_param_syncing_strategy():
    """``fed.robust`` validations of the JAX trainer, with its wording."""
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.train import Trainer

    cfg = ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
        "fed.num_clients=8", "train.snapshot_dir=", "fed.strategy=grad_avg",
        "fed.robust.method=median"])
    data = make_synthetic_mind(num_news=32, num_train=64, num_valid=0, title_len=12,
                               his_len_range=(2, 10), seed=0)
    states = np.zeros((32, 12, 48), np.float32)
    with pytest.raises(ValueError, match="robust.method"):
        Trainer(cfg, data, states, device="cpu")
    cfg.fed.robust.method = "krum"
    with pytest.raises(ValueError, match="unknown fed.robust.method"):
        Trainer(cfg, data, states, device="cpu")
