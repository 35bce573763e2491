"""Port parity for chaos client faults and the round weights (CPU): the
participation mask against JAX's for 210 (seed, round, K, fraction) cases,
``parse_faults`` and ``FaultPlan`` against the JAX package's, the update
fault against ``_apply_update_fault``, a chaos-enabled step without faults
bitwise equal to a chaos-free one, the trainer's weight composition, and
the refused keys. Bars: bitwise everywhere (the same numpy draws and the
same f32 arithmetic).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.config import ChaosConfig as JaxChaosConfig
from fedrec_tpu.fed.chaos import FaultPlan as JaxFaultPlan
from fedrec_tpu.fed.chaos import parse_faults as jax_parse_faults
from fedrec_tpu.fed.strategies import participation_mask as jax_participation_mask
from fedrec_tpu.train.step import _apply_update_fault as jax_apply_update_fault
from fedrec_tpu_torch.config import ChaosConfig, ExperimentConfig
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.fed import get_strategy, participation_mask
from fedrec_tpu_torch.fed.chaos import FAULT_CODES, FaultPlan, apply_update_fault, parse_faults
from fedrec_tpu_torch.fed.strategies import jax_uniform
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.obs import MetricsRegistry, set_registry
from fedrec_tpu_torch.params import init_params
from fedrec_tpu_torch.train import Trainer, build_fed_train_step, init_client_state
from fedrec_tpu_torch.train import replicate_state


# ------------------------------------------------------ participation mask
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 16, 100])
def test_participation_mask_equals_jax(k):
    """30 (seed, round, fraction) cases per K, keyed as both trainers key
    the mask: ``hash((train.seed, round)) & 0x7FFFFFFF``."""
    cases = itertools.product((0, 42, 12345), (0, 1, 7, 99, 12345), (0.3, 0.5))
    for seed, rnd, fraction in cases:
        key = hash((seed, rnd)) & 0x7FFFFFFF
        want = np.asarray(jax_participation_mask(jax.random.PRNGKey(key), k, fraction))
        got = participation_mask(key, k, fraction)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed} round {rnd} f {fraction}")


def test_jax_uniform_is_bitwise_jax_random_uniform():
    for seed in (0, 1, 42, 2**31 - 1, 2**32 - 1):
        for n in (1, 4, 8, 100):
            want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
            np.testing.assert_array_equal(jax_uniform(seed, n).view(np.uint32),
                                          want.view(np.uint32))
    with pytest.raises(ValueError):
        jax_uniform(-1, 2)


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("spec", ["nan@2:3,scale@*:5x100,flip@4:2", "", " nan@*:0 , flip@1:7",
                                  "scale@0:1x0.5"])
def test_parse_faults_equals_jax(spec):
    assert parse_faults(spec, 8) == jax_parse_faults(spec, 8)


@pytest.mark.parametrize("bad", ["nan@2", "warp@1:2", "nan@x:2", "nan@1:99", "scale@1:2x?"])
def test_parse_faults_rejects_malformed_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jax_parse_faults(bad, 8)
    with pytest.raises(ValueError) as got:
        parse_faults(bad, 8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("over", [
    dict(seed=3, drop_rate=0.3, straggle_rate=0.1, faults="nan@*:3"),
    dict(seed=1, drop_rate=0.4, straggle_rate=0.4),
    dict(seed=0, faults="nan@2:3,scale@*:5x100,flip@1:0"),
    dict(seed=7, drop_rate=0.3, faults="nan@*:3,scale@*:5x100"),
])
def test_fault_plan_equals_jax(over):
    want = JaxFaultPlan(JaxChaosConfig(enabled=True, **over), num_clients=8)
    got = FaultPlan(ChaosConfig(enabled=True, **over), num_clients=8)
    for r in range(12):
        a, b = got.round_faults(r), want.round_faults(r)
        for f in ("weight_mask", "codes", "scales"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f"round {r} {f}")
        assert (a.dropped, a.straggled, a.injected, a.any) == (
            b.dropped, b.straggled, b.injected, b.any)
        for key, v in got.batch_keys(r).items():
            np.testing.assert_array_equal(v, want.batch_keys(r)[key])


@pytest.mark.parametrize("code,scale", [(0, 1.0), (1, 1.0), (2, 100.0), (2, 0.3), (3, 1.0)])
def test_update_fault_equals_jax(code, scale):
    rng = np.random.default_rng(code)
    u = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    want = jax_apply_update_fault([jnp.asarray(x) for x in u], jnp.int32(code),
                                  jnp.float32(scale))
    got = apply_update_fault([torch.from_numpy(x) for x in u], np.int32(code), np.float32(scale))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if code == 0:  # untouched, not u * 1
        assert all(g is x for g, x in zip(apply_update_fault(u, 0, 1.0), u))


# ------------------------------------------------------------ in the step
def _cfg(*over):
    return ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
        "data.batch_size=8", "fed.num_clients=4", "model.text_encoder_mode=head",
        "train.snapshot_dir=", "train.eval_every=1000", "fed.rounds=2", *over])


def _data(cfg):
    data = make_synthetic_mind(num_news=64, num_train=128, num_valid=32, title_len=12,
                               his_len_range=(2, 10), seed=0, popular_frac=0.2)
    toks = np.random.default_rng(1).standard_normal((64, 12, 48)).astype(np.float32)
    return data, toks


def test_chaos_without_faults_is_bitwise_the_plain_step():
    """chaos.enabled with code 0 everywhere changes nothing (code 0 is
    exact); a scale fault on client 2 moves client 2 alone, by its update
    times the scale."""
    rng = np.random.default_rng(0)
    batch = {"candidates": rng.integers(1, 64, (4, 8, 5)), "history": rng.integers(0, 64, (4, 8, 10)),
             "labels": np.zeros((4, 8), np.int64)}
    toks = torch.from_numpy(rng.standard_normal((64, 12, 48)).astype(np.float32))
    out = {}
    for name, over, faults in (("plain", [], None), ("none", ["chaos.enabled=1"], (0, 1.0)),
                               ("scale", ["chaos.enabled=1"], (2, 10.0))):
        cfg = _cfg(*over)
        model = init_params(NewsRecommender(cfg.model), seed=0)
        states = replicate_state(init_client_state(model, cfg, seed=0), 4)
        before = [p.detach().clone() for p in states[2].model.parameters()]
        step = build_fed_train_step(model, cfg, get_strategy("local"), device="cpu")
        b = dict(batch)
        if faults is not None:
            codes = np.zeros(4, np.int32)
            codes[2] = faults[0]
            scales = np.ones(4, np.float32)
            scales[2] = faults[1]
            b.update({"chaos.code": codes, "chaos.scale": scales})
        states, m = step(states, b, toks)
        out[name] = ([[p.detach() for p in st.model.parameters()] for st in states], m, before)
    plain, none, scale = out["plain"], out["none"], out["scale"]
    for a, b in zip(plain[0], none[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for c in (0, 1, 3):
        assert all(torch.equal(x, y) for x, y in zip(plain[0][c], scale[0][c]))
    # (p0 + 10 u) - p0 against 10 ((p0 + u) - p0): each side rounds p0 + u
    # once, an ulp of p0 (|p0| < 2), times 10 on the right
    for x, y, p0 in zip(plain[0][2], scale[0][2], scale[2]):
        torch.testing.assert_close(y - p0, (x - p0) * 10.0, rtol=0, atol=3e-6)
    torch.testing.assert_close(scale[1]["health.update_norm"][2],
                               plain[1]["health.update_norm"][2] * 10.0, rtol=1e-5, atol=0)


def test_trainer_weights_compose_participation_chaos_and_quarantine():
    set_registry(MetricsRegistry())
    cfg = _cfg("fed.participation=0.5", "chaos.enabled=1", "chaos.seed=7",
               "chaos.drop_rate=0.3", "chaos.faults=nan@1:3")
    cfg.fed.num_clients = 8
    data, toks = _data(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    plan = JaxFaultPlan(JaxChaosConfig(enabled=True, seed=7, drop_rate=0.3), num_clients=8)
    for r in range(6):
        key = jax.random.PRNGKey(hash((cfg.train.seed, r)) & 0x7FFFFFFF)
        want = np.asarray(jax_participation_mask(key, 8, 0.5)) * plan.round_faults(r).weight_mask
        np.testing.assert_array_equal(t._round_weights(r), want)
    t._quarantine = {5: 2}
    w = t._round_weights(1)
    assert w[5] == 0.0
    counts = t.registry.get("chaos.faults_total")
    # round 1 drew twice: a replay re-counts, as in the JAX trainer
    assert counts.value(kind="nan") == 2.0 and counts.value(kind="drop") > 0


def test_straggler_rounds_sleep_on_the_host(monkeypatch):
    slept = []
    monkeypatch.setattr("fedrec_tpu_torch.train.trainer.time.sleep", slept.append)
    cfg = _cfg("chaos.enabled=1", "chaos.straggle_rate=1.0", "chaos.straggle_ms=250")
    data, toks = _data(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    assert not t._round_weights(0).any() and slept == [0.25]


@pytest.mark.parametrize("key,value", [("wire_faults", "drop@*"), ("wire_seed", "3"),
                                       ("wire_faults", "delay@2:150")])
def test_unported_chaos_keys_are_refused_by_name(key, value):
    """The wire faults are ported (``fed.chaos.ChaosProxy``, which the run
    CLI puts in front of ``--agg-server``): the trainer ignores the keys, as
    the JAX trainer does, and a malformed plan is refused naming its entry."""
    cfg = _cfg("chaos.enabled=1", f"chaos.{key}={value}")
    data, toks = _data(cfg)
    Trainer(cfg, data, toks, device="cpu")
    from fedrec_tpu_torch.fed.chaos import WireFaultPlan

    plan = WireFaultPlan(cfg.chaos.wire_faults, seed=cfg.chaos.wire_seed)
    assert [e[0] for e in plan.entries] == ([value.split("@")[0]] if key == "wire_faults"
                                            else [])
    with pytest.raises(ValueError, match=r"chaos\.wire_faults entry 'warp@1-2'"):
        WireFaultPlan(f"{cfg.chaos.wire_faults},warp@1-2")


@pytest.mark.parametrize("key,value", [("kill_round", "2"), ("kill_process", "0"),
                                       ("torn_snapshot_round", "1")])
def test_host_fault_keys_are_inert_in_the_trainer(key, value):
    """The coordinator deployment's host faults (``cli.coordinator``) build a
    single-process ``Trainer`` untouched, as in the JAX package."""
    cfg = _cfg("chaos.enabled=1", f"chaos.{key}={value}")
    data, toks = _data(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    assert getattr(t.cfg.chaos, key) == int(value)


def test_chaos_config_accepts_the_cli_spelling():
    cfg = ExperimentConfig().apply_overrides(["chaos.enabled=1", "chaos.faults=nan@1:2",
                                              "fed.robust.method=median"])
    assert cfg.chaos.faults == "nan@1:2" and cfg.fed.robust.method == "median"
    assert FAULT_CODES == {"nan": 1, "scale": 2, "flip": 3}
