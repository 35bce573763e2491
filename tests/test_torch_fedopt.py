"""FedOpt in the port (``fed.strategies.ServerOptimizer``, ``fed.server_opt``)
against the JAX package's.

The server step is numpy on the host in both packages, with the same
expressions and dtypes, so on the same inputs the port's sgd, FedAvgM and
FedAdam steps must equal the JAX ones bitwise. A FedAdam ``Trainer`` run
over a sampled population must match the JAX ``Trainer`` at the trajectory
bars. The rest is the port's own: sgd at lr 1 without momentum is FedAvg,
the buffers resume bitwise and roll back with the round, and a round costs
one device-to-host and one host-to-device copy.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

from fedrec_tpu.fed.strategies import ServerOptimizer as JaxServerOptimizer
from fedrec_tpu_torch.fed import ServerOptimizer
from fedrec_tpu_torch.train.checkpoint import SERVER_OPT_SIDECAR

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_population import (  # noqa: E402
    _SAMPLED,
    NOISE_LEAVES,
    _bits,
    _port_trainer,
    _same_bits,
    assert_runs_match,
    run_against_jax,
)


def _params(rng, shapes=((7, 3), (3,), (2, 5, 4))):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind,lr,momentum", [("sgd", 1.0, 0.0), ("sgd", 0.7, 0.9),
                                              ("adam", 0.01, 0.0), ("adam", 1.0, 0.9)])
def test_server_step_equals_jax_bitwise_over_five_steps(kind, lr, momentum):
    rng = np.random.default_rng(0)
    g = _params(rng)
    j, p = JaxServerOptimizer(kind, lr, momentum), ServerOptimizer(kind, lr, momentum)
    jg = {f"leaf{i}": x for i, x in enumerate(g)}
    for _ in range(5):
        mean = [x + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in g]
        want = j.step(jg, {f"leaf{i}": x for i, x in enumerate(mean)})
        got = p.step(g, mean)
        for i, x in enumerate(got):
            assert x.dtype == want[f"leaf{i}"].dtype == np.float32
            np.testing.assert_array_equal(x, want[f"leaf{i}"])
        g, jg = got, want
    assert p._state["t"] == j._state["t"] == 5


def test_state_bytes_round_trip_and_guards():
    rng = np.random.default_rng(1)
    g = _params(rng)
    for kind in ("sgd", "adam"):
        a = ServerOptimizer(kind, 0.5, 0.9)
        b = ServerOptimizer(kind, 0.5, 0.9)
        assert b.load_state(a.state_bytes(-1), g) == -1 and b._state is None
        for _ in range(3):
            a.step(g, [x * 0.9 for x in g])
        assert b.load_state(a.state_bytes(7), [x.shape for x in g]) == 7
        for x, y in zip(a.step(g, [x * 0.5 for x in g]), b.step(g, [x * 0.5 for x in g])):
            np.testing.assert_array_equal(x, y)
        with pytest.raises(ValueError, match="saved shapes"):
            ServerOptimizer(kind).load_state(a.state_bytes(7), [(1,)] * 3)
    with pytest.raises(ValueError, match="this run's fed.server_opt"):
        ServerOptimizer("adam").load_state(ServerOptimizer("sgd").state_bytes(0))
    with pytest.raises(ValueError, match="unknown server optimizer"):
        ServerOptimizer("lamb")


def test_fedadam_sampled_run_matches_jax():
    """FedAdam over a sampled population against the JAX ``Trainer``. Server
    Adam turns any pseudo-gradient, rounding noise included, into a step of
    up to about ``server_lr`` (|m_hat| / sqrt(v_hat) stays below 2 over a few
    rounds), so the zero-gradient leaves, whose pseudo-gradient is noise,
    may part by two such steps a round beyond the clients' own noise bar."""
    lr, rounds = 0.01, 3
    jt, pt, results = run_against_jax(16, 4, rounds, **{**_SAMPLED, "fed.server_opt": "adam",
                                                        "fed.server_lr": lr})
    assert pt.server_opt._state["t"] == jt.server_opt._state["t"] == rounds
    assert_runs_match(jt, pt, results, noise_bar=1e-3 + 4 * lr * rounds)


def test_sgd_at_lr_one_without_momentum_is_fedavg_to_one_rounding():
    """sgd at lr 1 without momentum is FedAvg in exact arithmetic: the new
    global is ``g - (g - m)``. In f32 that equals the mean ``m`` wherever
    ``g - m`` is exact (Sterbenz: within a factor 2), else it is one
    rounding of ``g - m`` off, as in the JAX package, whose expressions the
    port keeps. One round: every parameter within that rounding of
    FedAvg's; three rounds: the same round losses, and the parameters at
    the trajectory bars (the zero-gradient leaves excepted, which the
    clients' Adam drives from rounding noise)."""
    over = {"fed.server_opt": "sgd", "fed.server_lr": 1.0, "fed.server_momentum": 0.0}
    t0, t1 = _port_trainer(pop=0, rounds=1), _port_trainer(pop=0, rounds=1, **over)
    g = [p.detach().numpy().copy() for p in t1._slot_params(0)]
    t0.run()
    t1.run()
    for gi, m, x in zip(g, t0._slot_params(0), t1._slot_params(0)):
        m, x = m.detach().numpy(), x.detach().numpy()
        assert (np.abs(x - m) <= np.spacing(np.abs(gi - m))).all()
    t0, t1 = _port_trainer(pop=0, rounds=3), _port_trainer(pop=0, rounds=3, **over)
    h0, h1 = t0.run(), t1.run()
    np.testing.assert_allclose([r.train_loss for r in h1], [r.train_loss for r in h0],
                               rtol=1e-6)
    for name_a, a, b in zip((n for n, _ in t0.states[0].model.named_parameters()),
                            _bits(t0), _bits(t1)):
        if not name_a.endswith(NOISE_LEAVES):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=1e-4)


def test_one_copy_down_and_one_up_a_round(monkeypatch):
    t = _port_trainer(pop=16, rounds=3, **{**_SAMPLED, "fed.server_opt": "sgd"})
    down, up = [], []
    params_host, adopt = t._params_host, t._adopt_global
    monkeypatch.setattr(t, "_params_host", lambda c: (down.append(c), params_host(c))[1])
    monkeypatch.setattr(t, "_adopt_global", lambda p: (up.append(1), adopt(p))[1])
    t.run()
    # the first round also reads its entry global; later ones reuse the
    # last broadcast
    assert down == [0] * 4 and len(up) == 3
    ref = [p.detach().numpy() for p in t._slot_params(0)]
    for c in range(len(t.states)):
        for x, y in zip(t._slot_params(c), ref):
            np.testing.assert_array_equal(x.detach().numpy(), y)


def test_fedopt_resume_is_bitwise_and_warns_without_its_file(tmp_path, capsys):
    kw = {**_SAMPLED, "fed.server_opt": "sgd", "fed.server_momentum": 0.9,
          "fed.population.resident_cap": 2}
    ta = _port_trainer(pop=16, rounds=4, snap=str(tmp_path / "a"), **kw)
    ta.run()
    _port_trainer(pop=16, rounds=2, snap=str(tmp_path / "b"), **kw).run()
    tc = _port_trainer(pop=16, rounds=4, snap=str(tmp_path / "b"), **kw)
    assert tc.start_round == 2
    tc.run()
    assert _same_bits(_bits(ta), _bits(tc))
    for x, y in zip(ta.server_opt._state["buf"], tc.server_opt._state["buf"]):
        np.testing.assert_array_equal(x, y)
    (tmp_path / "b" / "round_3" / SERVER_OPT_SIDECAR).unlink()
    capsys.readouterr()
    _port_trainer(pop=16, rounds=5, snap=str(tmp_path / "b"), **kw)
    assert "without server_opt_state.npz" in capsys.readouterr().out


def test_rollback_restores_the_server_buffers():
    """A NaN round rolled back and replayed steps the server optimizer once
    (the capture holds its buffers and round-entry global)."""
    t = _port_trainer(pop=0, rounds=3, **{"fed.server_opt": "adam", "fed.server_lr": 0.01,
                                          "fed.robust.recover": True, "chaos.enabled": True,
                                          "chaos.faults": "nan@1:2"})
    hist = t.run()
    assert t.registry.counter("fed.rollbacks_total").value() == 1
    assert t.server_opt._state["t"] == 3
    assert all(np.isfinite(r.train_loss) for r in hist)
    assert all(np.isfinite(m).all() for m in t.server_opt._state["m"])


def test_server_opt_needs_a_param_syncing_strategy():
    with pytest.raises(ValueError, match="requires a strategy that syncs params"):
        _port_trainer(pop=0, **{"fed.server_opt": "adam", "fed.strategy": "grad_avg"})
    with pytest.raises(ValueError, match="unknown server optimizer"):
        _port_trainer(pop=0, **{"fed.server_opt": "lamb"})
