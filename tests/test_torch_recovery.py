"""Port parity for quarantine-and-rollback (``fed.robust.recover``, CPU): the
scenarios of ``tests/test_recovery.py`` on the port's ``Trainer`` (a chaos
NaN update aborting with ``recover=false``; quarantined, rolled back,
replayed and healed with ``recover=true``; the retry budget; two bad
clients; an outlier client), a recovered 5-round run against the JAX
``Trainer``, and the recovered run repeated bitwise.

Tolerances: ``tests/test_torch_trainer.py``'s bars (round losses rtol 1e-5
/ atol 1e-6, parameters rtol 2e-4 / atol 1e-4, the zero-gradient leaves at
1e-3).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fedrec_tpu.config import ExperimentConfig as JaxExperimentConfig
from fedrec_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from fedrec_tpu.obs import Tracer as JaxTracer
from fedrec_tpu.obs import set_registry as jax_set_registry
from fedrec_tpu.obs import set_tracer as jax_set_tracer
from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, TrainingHealthError, set_registry
from fedrec_tpu_torch.obs import set_tracer
from fedrec_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _assert_tree_close, _client_tree, _to_flax  # noqa: E402

_BASE = dict(model__news_dim=32, model__num_heads=4, model__head_dim=8, model__query_dim=16,
             model__bert_hidden=48, model__text_encoder_mode="head", data__max_his_len=10,
             data__max_title_len=12, data__batch_size=8, fed__num_clients=8,
             fed__strategy="param_avg", train__snapshot_dir="", train__eval_every=1000,
             chaos__enabled=True)


def _apply(cfg, over: dict):
    for key, value in over.items():
        *path, leaf = key.split("__")
        node = cfg
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    return cfg


def _data():
    data = make_synthetic_mind(num_news=64, num_train=256, num_valid=64, title_len=12,
                               his_len_range=(2, 10), seed=0, popular_frac=0.2)
    toks = np.random.default_rng(1).standard_normal((64, 12, 48)).astype(np.float32)
    return data, toks


def _trainer(recover: bool, rounds: int = 5, faults: str = "nan@1:3", **over) -> Trainer:
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    cfg = _apply(ExperimentConfig(), {**_BASE, "fed__rounds": rounds, "chaos__faults": faults,
                                      "fed__robust__recover": recover, **over})
    data, toks = _data()
    return Trainer(cfg, data, toks, device="cpu")


def _rollbacks(tracer):
    return [e for e in tracer._events if e["name"] == "rollback"]


def test_recover_false_aborts_naming_the_cell():
    t = _trainer(recover=False)
    with pytest.raises(TrainingHealthError,
                       match=r"\[nonfinite\] at round 1 step 0 client 3: .*Set obs\.dir"):
        t.run()
    assert t.registry.counter("health.nonfinite_steps_total").value() > 0


def test_recover_true_quarantines_rolls_back_and_completes():
    t = _trainer(recover=True)
    history = t.run()
    assert len(history) == 5
    assert all(np.isfinite([r.train_loss for r in history]))
    reg = t.registry
    assert reg.counter("fed.rollbacks_total").value() == 1
    assert reg.counter("fed.quarantines_total").value() == 1
    assert reg.gauge("fed.quarantine_active").value() == 0.0  # expired, healed
    # the rolled-back round had aggregated before its health check, as in JAX
    assert reg.counter("fed.robust_rounds_total", labels=("method",)).value(method="mean") == 6
    assert reg.counter("chaos.faults_total", labels=("kind",)).value(kind="nan") == 2  # + replay
    rb = _rollbacks(t.tracer)
    assert len(rb) == 1 and rb[0]["args"]["client"] == 3 and rb[0]["args"]["round"] == 1
    replayed = [e for e in t.tracer._events
                if e["name"] == "fed_round" and "quarantined" in e["args"]]
    assert replayed and replayed[0]["args"] == {"step_num": 1, "quarantined": [3],
                                                "replay_retry": 1}
    for st in t.states:  # the healed client rejoined: every client finite
        assert all(torch.isfinite(p).all() for p in st.model.parameters())
    # zeroed at the heal after round 3 (quarantined for rounds 1-3): round 4's 4 steps
    assert t.states[3].opt_user.count == 4 and t.states[0].opt_user.count == 5 * 4


def test_recover_retry_budget_bounds_rollbacks():
    t = _trainer(recover=True, faults="nan@1:3,nan@1:5")
    t.cfg.fed.robust.max_retries = 1
    with pytest.raises(TrainingHealthError, match="client 5"):
        t.run()
    assert t.registry.counter("fed.rollbacks_total").value() == 1


def test_recover_two_bad_clients_with_budget():
    t = _trainer(recover=True, faults="nan@1:3,nan@1:5")
    history = t.run()
    assert len(history) == 5 and all(np.isfinite(r.train_loss) for r in history)
    assert t.registry.counter("fed.quarantines_total").value() == 2
    assert [e["args"]["client"] for e in _rollbacks(t.tracer)] == [3, 5]


def test_recover_from_outlier_scale_poison():
    t = _trainer(recover=True, faults="scale@1:2x1000", rounds=4)
    history = t.run()
    assert len(history) == 4 and all(np.isfinite(r.train_loss) for r in history)
    rb = _rollbacks(t.tracer)
    assert rb and rb[0]["args"]["kind"] == "outlier" and rb[0]["args"]["client"] == 2


def test_recover_validation():
    data, toks = _data()
    cfg = _apply(ExperimentConfig(), {**_BASE, "fed__strategy": "grad_avg",
                                      "fed__robust__recover": True})
    with pytest.raises(ValueError, match="recover"):
        Trainer(cfg, data, toks, device="cpu")
    cfg.fed.strategy = "param_avg"
    cfg.obs.health.sentry = False
    with pytest.raises(ValueError, match="sentry"):
        Trainer(cfg, data, toks, device="cpu")


def test_recovered_run_repeats_bitwise():
    runs = []
    for _ in range(2):
        t = _trainer(recover=True, rounds=3, model__dropout_rate=0.2)
        losses = [r.train_loss for r in t.run()]
        runs.append((losses, [p.detach().clone() for st in t.states
                              for p in st.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_train_round_recovering_is_run_round_by_round():
    """The per-round entry point (the JAX trainer's, for the coordinator's
    loop) gives ``run``'s rounds and parameters to the bit."""
    a = _trainer(recover=True, rounds=5)
    want = [r.train_loss for r in a.run()]
    b = _trainer(recover=True, rounds=5)
    got = [b.train_round_recovering(r).train_loss for r in range(5)]
    assert got == want and b._quarantine == {}
    assert all(torch.equal(p, q) for x, y in zip(a.states, b.states)
               for p, q in zip(x.model.parameters(), y.model.parameters()))


@pytest.mark.parametrize("method", ["mean", "trimmed_mean"])
def test_recovered_run_matches_jax_trainer(method):
    """``nan@1:3`` with ``recover=true`` for 5 rounds in both packages
    (dropout 0, the same initial parameters, the fused route): the same
    rollback, the same round losses, every client's final parameters."""
    over = {**_BASE, "fed__rounds": 5, "chaos__faults": "nan@1:3", "fed__robust__recover": True,
            "fed__robust__method": method, "model__dropout_rate": 0.0,
            "optim__user_lr": 3e-3, "optim__news_lr": 3e-3,
            # test_torch_trainer.py's parity route: the kernels leave the
            # zero-gradient leaves at exactly zero in both packages, where
            # the dense route's float noise would be Adam-amplified
            "model__fuse_hot_path": True, "model__use_pallas": True}
    data, toks = _data()
    jax_set_registry(JaxMetricsRegistry())
    jax_set_tracer(JaxTracer())
    jt = JaxTrainer(_apply(JaxExperimentConfig(), over), data, toks)
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    pt = Trainer(_apply(ExperimentConfig(), over), data, toks, device="cpu")
    up, np_ = jax.tree_util.tree_map(np.asarray, jt._client0_params())
    pt.set_global_params(up, np_)
    want, got = jt.run(), pt.run()
    assert [r.round_idx for r in got] == [r.round_idx for r in want]
    np.testing.assert_allclose([r.train_loss for r in got], [r.train_loss for r in want],
                               rtol=1e-5, atol=1e-6)
    assert pt.registry.counter("fed.rollbacks_total").value() == \
        jt.registry.counter("fed.rollbacks_total").value() == 1
    for c in range(8):
        _assert_tree_close(_to_flax(pt.states[c].model), _client_tree(jt.state, c))
