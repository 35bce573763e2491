"""Port parity for the training-health sentry (CPU): the train step's health
vector against the JAX step's (K=8 clients on the fake CPU mesh of
``tests/conftest.py``, joint and decoupled mode), the trajectory bitwise
equal with the sentry on and off, a forced non-finite update flagged on
every client, and the port's ``HealthMonitor`` against the JAX package's on
the cases of ``tests/test_obs_health.py``.

Tolerances: the norms are f32 sums over the same values in another order,
rtol 1e-5 (``test_torch_train.py``'s gradient bar, relative); the monitors
get the same float64 arrays and must agree exactly.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fedrec_tpu.config import HealthConfig as JaxHealthConfig
from fedrec_tpu.fed import get_strategy as jax_get_strategy
from fedrec_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from fedrec_tpu.obs.health import HealthMonitor as JaxHealthMonitor
from fedrec_tpu.parallel import shard_batch
from fedrec_tpu.train import build_fed_train_step as jax_build_fed_train_step
from fedrec_tpu.train import encode_all_news as jax_encode_all_news
from fedrec_tpu_torch.config import ExperimentConfig, HealthConfig
from fedrec_tpu_torch.fed import get_strategy
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.obs import MetricsRegistry
from fedrec_tpu_torch.obs.health import HealthMonitor, _observe_array
from fedrec_tpu_torch.params import from_flax
from fedrec_tpu_torch.train import build_fed_train_step, encode_all_news, init_client_state
from fedrec_tpu_torch.train import replicate_state

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _client_tree  # noqa: E402
from test_train import _batch_dict, make_setup, small_cfg  # noqa: E402

HEALTH_KEYS = ("health.grad_norm", "health.update_norm", "health.param_norm",
               "health.nonfinite")
_K = 8


def _port_cfg(mode: str, **over) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
        "data.batch_size=8", f"fed.num_clients={_K}", "model.dropout_rate=0.0",
        "optim.user_lr=3e-3", "optim.news_lr=3e-3",
        f"model.text_encoder_mode={'head' if mode == 'joint' else 'table'}",
        *(f"{k}={v}" for k, v in over.items()),
    ])


@pytest.fixture(scope="module")
def jax_steps():
    """One JAX step per mode from the same initial state, compiled once:
    ``(jax_cfg, state, first batch, token states, {mode: (metrics, table)})``."""
    jcfg = small_cfg(optim__user_lr=3e-3, optim__news_lr=3e-3, model__dropout_rate=0.0)
    _, batcher, toks, model, stacked, mesh = make_setup(jcfg, seed=0)
    batch = _batch_dict(next(iter(batcher.epoch_batches_sharded(_K, 0))))
    out = {}
    jstep = jax_build_fed_train_step(model, jcfg, jax_get_strategy("grad_avg"), mesh,
                                     mode="joint")
    out["joint"] = (jstep(stacked, shard_batch(mesh, batch), toks)[1], toks)
    p0 = jax.tree_util.tree_map(lambda x: x[0], stacked.news_params)
    table = jax_encode_all_news(model, p0, toks)
    jstep = jax_build_fed_train_step(model, jcfg, jax_get_strategy("local"), mesh,
                                     mode="decoupled")
    out["decoupled"] = (jstep(stacked, shard_batch(mesh, batch), table)[1], table)
    return jcfg, stacked, batch, out


def _port_states(cfg, jstate, seed: int = 0):
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    return model, replicate_state(init_client_state(model, cfg, seed=seed), _K)


@pytest.mark.parametrize("mode", ["joint", "decoupled"])
def test_health_vector_matches_jax(jax_steps, mode):
    """Each client's grad, update and param norms equal the JAX step's at
    rtol 1e-5 (grad_avg in joint mode, local in decoupled mode, as the JAX
    sentry tests run them); no cell is flagged."""
    _, jstate, batch, out = jax_steps
    jm, table = out[mode]
    cfg = _port_cfg(mode)
    model, states = _port_states(cfg, jstate)
    strategy = "grad_avg" if mode == "joint" else "local"
    step = build_fed_train_step(model, cfg, get_strategy(strategy), mode=mode, device="cpu")
    _, m = step(states, batch, torch.from_numpy(np.array(table)))
    assert set(HEALTH_KEYS) <= set(m) and "health.clip_rate" not in m
    for key in HEALTH_KEYS:
        assert m[key].shape == (_K,), key
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]).reshape(-1),
                                   rtol=1e-5, atol=0, err_msg=key)
    assert m["health.nonfinite"].dtype == torch.int32 and int(m["health.nonfinite"].sum()) == 0


@pytest.mark.parametrize("mode", ["joint", "decoupled"])
def test_sentry_leaves_the_trajectory_bitwise_unchanged(mode):
    """Three steps with dropout on, the sentry on and off: the losses,
    parameters, optimizer moments and dropout streams are bitwise equal,
    and only the health keys differ between the metrics."""
    runs = {}
    for sentry in (True, False):
        cfg = _port_cfg(mode, **{"obs.health.sentry": int(sentry), "model.dropout_rate": 0.2})
        jcfg = small_cfg(model__dropout_rate=0.2)
        _, batcher, toks, _, jstate, _ = make_setup(jcfg, seed=0)
        model, states = _port_states(cfg, jstate, seed=3)
        table = torch.from_numpy(np.array(toks))
        if mode == "decoupled":
            table = encode_all_news(model, table, device="cpu")
        step = build_fed_train_step(model, cfg, get_strategy("param_avg"), mode=mode,
                                    device="cpu")
        losses, keys = [], set()
        for i, b in enumerate(batcher.epoch_batches_sharded(_K, 0)):
            if i == 3:
                break
            states, m = step(states, _batch_dict(b), table)
            losses.append(m["loss"])
            keys = set(m)
        bits = [torch.stack(losses)]
        for st in states:
            bits += [p.detach() for p in st.model.parameters()]
            bits += [*st.opt_user.mu, *st.opt_user.nu, st.generator.get_state()]
        runs[sentry] = (bits, keys)
    (on, keys_on), (off, keys_off) = runs[True], runs[False]
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert keys_on - keys_off == set(HEALTH_KEYS) and keys_off <= keys_on


def test_forced_nonfinite_flags_every_client(jax_steps):
    """An infinite learning rate: every client's first update and params go
    non-finite while the loss stays finite; the sentry flags all K."""
    _, jstate, batch, out = jax_steps
    cfg = _port_cfg("joint", **{"optim.user_lr": "inf"})
    model, states = _port_states(cfg, jstate)
    step = build_fed_train_step(model, cfg, get_strategy("grad_avg"), device="cpu")
    _, m = step(states, batch, torch.from_numpy(np.array(out["joint"][1])))
    assert int(m["health.nonfinite"].sum()) == _K
    assert not torch.isfinite(m["health.update_norm"]).all()
    assert torch.isfinite(m["loss"]).all()


# ------------------------------------------------------------ the monitor
def _rows(S=3, C=4):
    return {
        "health.grad_norm": np.full((1, S, C), 0.5),
        "health.update_norm": np.full((1, S, C), 0.01),
        "health.param_norm": np.full((1, S, C), 10.0),
        "health.nonfinite": np.zeros((1, S, C)),
    }


def _case(name):
    """(health config kwargs, [(start_round, rows, round_losses, ignore)])
    for each of ``tests/test_obs_health.py``'s monitor cases, and more."""
    if name == "finite":
        return {}, [(0, _rows(), [1.0], None)]
    if name == "nonfinite_cell":
        rows = _rows()
        rows["health.nonfinite"][0, 2, 3] = 1
        rows["health.update_norm"][0, 2, 3] = np.inf
        return {}, [(5, rows, [1.0], None)]
    if name == "nonfinite_ignored":
        rows = _rows()
        rows["health.nonfinite"][0, 1, 2] = 1
        rows["health.nonfinite"][0, 2, 0] = 1
        return {}, [(1, rows, [1.0], {2}), (2, rows, [1.0], {0, 2})]
    if name == "outlier":
        rows = _rows(S=2, C=4)
        rows["health.update_norm"][0, :, 1] = 1.0
        return {"outlier_k": 3.0}, [(0, rows, [1.0], None), (1, rows, [1.0], {1})]
    if name == "outlier_with_nan_client":
        rows = _rows(S=2, C=5)
        rows["health.update_norm"][0, :, 4] = np.nan
        rows["health.update_norm"][0, :, 3] = 0.5
        return {"outlier_k": 3.0}, [(0, rows, [1.0], None)]
    if name == "loss_spike":
        steps = [(0, _rows(), [loss], None) for loss in (1.0, 1.1, 0.9)]
        return {"spike_factor": 4.0, "spike_window": 3}, steps + [(3, _rows(), [40.0], None)]
    if name == "spike_off":
        steps = [(0, _rows(), [1.0], None), (1, _rows(), [1.0], None)]
        return {"spike_factor": 0.0, "spike_window": 2}, steps + [(2, _rows(), [1e9], None)]
    if name == "clip_rate":
        rows = _rows(S=2, C=2)
        rows["health.clip_rate"] = np.asarray([[[0.25, 0.75], [1.0, 0.5]]])
        rows["health.clip_max_norm"] = np.asarray([[[3.0, 2.0], [9.0, 4.0]]])
        return {}, [(0, rows, [1.0], None)]
    raise KeyError(name)


_CASES = ["finite", "nonfinite_cell", "nonfinite_ignored", "outlier", "outlier_with_nan_client",
          "loss_spike", "spike_off", "clip_rate"]
_PUBLISHED = ("health.outlier_clients_total", "health.outlier_clients", "health.param_norm",
              "health.nonfinite_steps_total", "privacy.clip_rate_last", "privacy.max_grad_norm")


@pytest.mark.parametrize("name", _CASES)
def test_health_monitor_matches_jax(name):
    """The same arrays through both monitors: the same trigger (kind, round,
    step, client, detail), the same outlier list and the same published
    instruments, check after check."""
    kw, checks = _case(name)
    jreg, reg = JaxMetricsRegistry(), MetricsRegistry()
    jmon = JaxHealthMonitor(JaxHealthConfig(**kw), registry=jreg)
    mon = HealthMonitor(HealthConfig(**kw), registry=reg)
    for start, rows, losses, ignore in checks:
        want = jmon.check(start, {k: v.copy() for k, v in rows.items()}, losses,
                          ignore_clients=ignore)
        got = mon.check(start, {k: v.copy() for k, v in rows.items()}, losses,
                        ignore_clients=ignore)
        np.testing.assert_equal(got, want)  # NaN equal to NaN
        np.testing.assert_equal(mon.last_outliers, jmon.last_outliers)
    for metric in _PUBLISHED:
        j, p = jreg.get(metric), reg.get(metric)
        assert (j is None) == (p is None), metric
        if j is not None:
            assert p.value() == j.value(), metric
    for metric in ("health.grad_norm", "health.update_norm", "privacy.clip_rate"):
        np.testing.assert_equal(reg.get(metric).cell(), jreg.get(metric).cell(), err_msg=metric)


def test_observe_array_matches_the_observe_loop():
    """The vectorized publish lands every value in the bucket ``observe``
    would, the inclusive bound and +Inf included; a wrong arity raises."""
    reg = MetricsRegistry()
    values = [0.05, 1.0, 1.0001, 7.3, 50.0, np.inf]
    a = reg.histogram("loop", buckets=(1.0, 10.0))
    for v in values:
        a.observe(v)
    b = reg.histogram("bulk", buckets=(1.0, 10.0))
    _observe_array(b, np.asarray(values))
    assert a.cell() == b.cell()
    with pytest.raises(ValueError):
        b.merge_counts([1, 2], 0.0, 3)


def test_registry_snapshot_and_swap():
    from fedrec_tpu_torch.obs import get_registry, set_registry

    fresh = MetricsRegistry()
    prev = set_registry(fresh)
    try:
        assert get_registry() is fresh
        fresh.counter("c", labels=("kind",)).inc(2, kind="nan")
        fresh.gauge("g").set(1.5)
        snap = fresh.snapshot()
        assert snap["metrics"]["c"]["values"] == [{"labels": {"kind": "nan"}, "value": 2.0}]
        assert snap["metrics"]["g"]["values"][0]["value"] == 1.5
        with pytest.raises(ValueError):
            fresh.gauge("c")  # a name keeps its kind
        with pytest.raises(ValueError):
            fresh.counter("c", labels=("kind",)).inc()  # labels must match
    finally:
        set_registry(prev)
