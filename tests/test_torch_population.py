"""The port's cohort engine against the JAX package's
(``fedrec_tpu/fed/population.py``, ``fed/sampling.py``, the population
faults of ``fed/chaos.py`` and the JAX ``Trainer``'s cohort rounds).

The numpy pieces (the sampler's draws and state, ``population_report``,
the plans, the weights, the ledger, the shards and the batches) must equal
the JAX package's bitwise on the same inputs. A sampled ``Trainer`` run, at
dropout 0 from the JAX run's initial parameters, must draw the same
cohorts and keep the same ledger exactly, with round losses at rtol 1e-5
and parameters at rtol 2e-4 / atol 1e-4. The rest is the port's own: the
degenerate world, resume with spilled sidecars, the quorum policy, the
logical-client quarantine and the repacked pad, each beside the JAX test it
follows (``tests/test_population.py``).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu.config import ExperimentConfig as JaxConfig
from fedrec_tpu.data import make_synthetic_mind as jax_synthetic_mind
from fedrec_tpu.fed import chaos as jchaos
from fedrec_tpu.fed import population as jpop
from fedrec_tpu.fed import sampling as jsamp
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import IndexedSamples, index_samples
from fedrec_tpu_torch.fed import chaos as pchaos
from fedrec_tpu_torch.fed import population as ppop
from fedrec_tpu_torch.fed import sampling as psamp
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, set_registry, set_tracer
from fedrec_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _client_tree, _to_flax  # noqa: E402


def _eq(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _eq_tree(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _eq_tree(a[k], b[k])
        elif isinstance(a[k], (str, int)):
            assert a[k] == b[k], k
        else:
            _eq(a[k], b[k])


# ------------------------------------------------------------- sampler
@pytest.mark.parametrize("mode", ["uniform", "weighted", "skew"])
def test_sampler_draws_equal_jax_with_exclusions_and_attempts(mode):
    counts = np.random.default_rng(3).integers(1, 500, size=100)
    j = jsamp.CohortSampler(100, mode, seed=11, sample_counts=counts)
    p = psamp.CohortSampler(100, mode, seed=11, sample_counts=counts)
    for r in range(6):
        for attempt in (0, 2):
            for exclude in ((), {4, 17, 93}):
                _eq(p.draw(r, 9, exclude=exclude, attempt=attempt),
                    j.draw(r, 9, exclude=exclude, attempt=attempt))
        # full coverage: ascending ids (the degenerate contract)
        _eq(p.draw(r, 100, exclude={5}), j.draw(r, 100, exclude={5}))
        c = j.draw(r, 9)
        j.record(c)
        p.record(c)
    _eq_tree(p.state_dict(), j.state_dict())
    # a port sampler resumed from the JAX state draws the JAX schedule on
    q = psamp.CohortSampler(100, mode, seed=11, sample_counts=counts)
    q.load_state_dict(j.state_dict())
    for r in range(6, 9):
        _eq(q.draw(r, 9), j.draw(r, 9))
        q.record(j.draw(r, 9))
        j.record(j.draw(r, 9))
    with pytest.raises(ValueError, match="mismatch"):
        psamp.CohortSampler(50, mode, seed=11).load_state_dict(j.state_dict())
    with pytest.raises(ValueError, match="unknown fed.population.sampler"):
        psamp.validate_sampler_mode("roulette")


def test_sampler_skew_flattens_selection_histogram():
    uni = psamp.CohortSampler(64, "uniform", seed=0)
    skew = psamp.CohortSampler(64, "skew", seed=0)
    for r in range(60):
        for s in (uni, skew):
            s.record(s.draw(r, 8))
    assert (skew.selection_counts > 0).sum() >= (uni.selection_counts > 0).sum()
    assert np.std(skew.selection_counts) < np.std(uni.selection_counts)


# ------------------------------------------------- chaos population sim
def _plans(**over):
    jc, pc = JaxConfig().chaos, ExperimentConfig().chaos
    for c in (jc, pc):
        c.enabled, c.seed = True, 5
        for k, v in over.items():
            setattr(c, k, v)
    return jchaos.FaultPlan(jc, 4), pchaos.FaultPlan(pc, 4)


@pytest.mark.parametrize("over", [
    {"pop_drop_rate": 0.4, "pop_straggle_ms": 100.0},
    {"pop_flaky_fraction": 0.25, "pop_flaky_drop_rate": 0.9, "pop_drop_rate": 0.05},
    {"pop_straggle_ms": 40.0, "pop_straggle_sigma": 0.5},
])
def test_population_report_and_is_flaky_equal_jax(over):
    jp, pp = _plans(**over)
    ids = np.arange(0, 300, 3)
    for r in (0, 7):
        for attempt in (0, 1):
            for got, want in zip(pchaos.population_report(pp, r, ids, attempt),
                                 jchaos.population_report(jp, r, ids, attempt)):
                _eq(got, want)
            for got, want in zip(pp.population_report(r, ids, attempt),
                                 jp.population_report(r, ids, attempt)):
                _eq(got, want)
    assert [pp.is_flaky(c) for c in range(200)] == [jp.is_flaky(c) for c in range(200)]
    d0, l0 = pchaos.population_report(None, 3, ids)
    assert not d0.any() and not l0.any()


# --------------------------------------------------------- cohort plans
@pytest.mark.parametrize("pack,over_select,slots", [(True, 1.5, 8), (True, 2.0, 8),
                                                    (False, 1.0, 16)])
def test_cohort_plans_and_round_weights_equal_jax(pack, over_select, slots):
    jp, pp = _plans(pop_drop_rate=0.3, pop_straggle_ms=100.0)
    pop = 256 if pack else 16
    js = jsamp.CohortSampler(pop, "skew", seed=2)
    ps = psamp.CohortSampler(pop, "skew", seed=2)
    for r in range(4):
        exclude = {3, 40} if pack else ()
        jplan = jpop.build_cohort_plan(js, slots, r, over_select, chaos=jp, exclude=exclude,
                                       attempt=r % 2, pack=pack)
        pplan = ppop.build_cohort_plan(ps, slots, r, over_select, chaos=pp, exclude=exclude,
                                       attempt=r % 2, pack=pack)
        for f in ("sampled", "start_dropped", "slot_clients", "slot_real"):
            _eq(getattr(pplan, f), getattr(jplan, f))
        assert (pplan.round_idx, pplan.attempt, pplan.spares_unused) == (
            jplan.round_idx, jplan.attempt, jplan.spares_unused)
        for deadline in (0.0, 100.0):
            (pw, pev), (jw, jev) = (ppop.plan_round_weights(pplan, r, deadline, chaos=pp),
                                    jpop.plan_round_weights(jplan, r, deadline, chaos=jp))
            _eq(pw, jw)
            _eq_tree(pev, jev)
        js.record(jplan.sampled)
        ps.record(pplan.sampled)
    with pytest.raises(ValueError, match="over_select"):
        ppop.build_cohort_plan(ps, 8, 0, over_select=0.5)


def test_deadline_cuts_the_straggle_tail():
    _, pp = _plans(pop_straggle_ms=100.0, pop_straggle_sigma=1.0)
    pp.cfg.pop_drop_rate = 0.0
    plan = ppop.build_cohort_plan(psamp.CohortSampler(256, "uniform", seed=2), 8, 0, 1.0,
                                  chaos=pp)
    w, ev = ppop.plan_round_weights(plan, 0, deadline_ms=100.0, chaos=pp)
    assert 0 < ev["deadline_cut"].size < 8 and w.sum() == 8 - ev["deadline_cut"].size
    assert not set(ev["reported"].tolist()) & set(ev["deadline_cut"].tolist())


# -------------------------------------------------------------- ledger
def test_ledger_commit_quarantine_and_state_equal_jax():
    j, p = jpop.ParticipationLedger(16), ppop.ParticipationLedger(16)
    events = {"reported": np.array([1, 2]), "dropped": np.array([3]),
              "deadline_cut": np.array([2])}
    for led in (j, p):
        led.commit(np.array([1, 2, 3]), events)
        led.commit(np.array([2, 5]), {"reported": np.array([5])})
        led.quarantine(5, until_round=7)
        led.quarantine(9, until_round=4)
        led.quarantine(5, until_round=6)  # the later expiry wins
    _eq_tree(p.state_dict(), j.state_dict())
    assert p.coverage() == j.coverage() == 4 / 16
    assert p.active_quarantine(6) == j.active_quarantine(6) == {5}
    for pop in (10, 20):
        jr, pr = jpop.ParticipationLedger(pop), ppop.ParticipationLedger(pop)
        jr.load_state_dict(j.state_dict(), resize=True)
        pr.load_state_dict(j.state_dict(), resize=True)
        _eq_tree(pr.state_dict(), jr.state_dict())
    with pytest.raises(ValueError, match="population mismatch"):
        ppop.ParticipationLedger(8).load_state_dict(p.state_dict())


# ----------------------------------------------------------- population
def _indexed(num_train=259, seed=0):
    data = jax_synthetic_mind(num_news=64, num_train=num_train, num_valid=8, title_len=12,
                              his_len_range=(2, 10), seed=seed, popular_frac=0.2)
    return index_samples(data.train_samples, data.nid2index, 10)


def test_shards_seeds_and_cohort_batches_equal_jax():
    jp = jpop.ClientPopulation(16, num_rows=259, data_seed=5)
    pp = ppop.ClientPopulation(16, num_rows=259, data_seed=5)
    assert pp.shard_size == jp.shard_size == 16
    seen: set[int] = set()
    for c in range(16):
        _eq(pp.shard_rows(c), jp.shard_rows(c))
        assert pp.client_seed(c) == jp.client_seed(c)
        assert not seen & set(pp.shard_rows(c).tolist())
        seen.update(pp.shard_rows(c).tolist())
    assert pp.steps_per_epoch(8) == jp.steps_per_epoch(8) == 2
    from fedrec_tpu.data.batcher import IndexedSamples as JaxIndexed

    ix = _indexed()
    jix = JaxIndexed(**{f.name: getattr(ix, f.name) for f in dataclasses.fields(IndexedSamples)})
    for epoch, cohort, shuffle in ((0, [3, 0, 9, 3], True), (5, [15, 1, 2, 7], False)):
        jd, pd = JaxConfig().data, ExperimentConfig().data
        for d in (jd, pd):
            d.batch_size, d.shuffle = 8, shuffle
        got = list(pp.cohort_epoch_batches(np.array(cohort), ix, pd, epoch))
        want = list(jp.cohort_epoch_batches(np.array(cohort), jix, jd, epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for f in ("candidates", "history", "his_len", "labels"):
                _eq(getattr(g, f), getattr(w, f))
    with pytest.raises(ValueError, match="empty shards"):
        ppop.ClientPopulation(1000, num_rows=100)
    with pytest.raises(ValueError, match="smaller than data.batch_size"):
        ppop.ClientPopulation(10, num_rows=100, batch_size=64)


def test_sidecar_store_lru_spills_restores_and_persists(tmp_path):
    pop = ppop.ClientPopulation(8, num_rows=64, resident_cap=2, spill_dir=tmp_path / "spill")
    mk = lambda c: {"m": np.full((3,), float(c)), "v": [np.arange(2) + c, np.int64(c)]}  # noqa: E731
    for c in range(5):
        pop.put_sidecar(c, mk(c))
    assert pop.resident_sidecars == 2 and pop.spill_count == 3
    for c in range(5):  # spilled and resident both round-trip exactly
        sc = pop.get_sidecar(c)
        _eq(sc["m"], mk(c)["m"])
        _eq(sc["v"][0], mk(c)["v"][0])
        _eq(sc["v"][1], mk(c)["v"][1])
    assert pop.get_sidecar(7) is None
    # the store goes into a snapshot directory by links; a later spill of
    # the same client does not touch the snapshot's copy
    manifest = pop.save_store(tmp_path / "snap")
    assert manifest["ids"].tolist() == [0, 1, 2, 3, 4]
    pop.put_sidecar(0, mk(40))
    pop.put_sidecar(5, mk(5))
    pop.put_sidecar(6, mk(6))  # spills 0 with its new contents
    other = ppop.ClientPopulation(8, num_rows=64, resident_cap=2, spill_dir=tmp_path / "spill")
    other.load_store(tmp_path / "snap", manifest)
    assert other.stored_ids() == [0, 1, 2, 3, 4]
    for c in range(5):
        _eq(other.get_sidecar(c)["m"], mk(c)["m"])
    pop.reset_sidecar(0)  # quarantine healing forgets the sidecar
    assert pop.get_sidecar(0) is None
    with pytest.raises(ValueError, match="structure changed"):
        pop.put_sidecar(6, {"different": np.zeros(1)})


# ====================================================== trainer level
_SMALL = {"model.news_dim": 32, "model.num_heads": 4, "model.head_dim": 8,
          "model.query_dim": 16, "model.bert_hidden": 48, "model.dropout_rate": 0.0,
          "model.text_encoder_mode": "head", "data.max_his_len": 10, "data.max_title_len": 12,
          "data.batch_size": 8, "fed.strategy": "param_avg", "train.eval_every": 1000,
          "optim.user_lr": 3e-3, "optim.news_lr": 3e-3}


def _set(cfg, over: dict):
    for key, v in over.items():
        obj = cfg
        *parents, leaf = key.split(".")
        for part in parents:
            obj = getattr(obj, part)
        setattr(obj, leaf, v)
    return cfg


def _copy_into(mine, theirs) -> None:
    for key, val in vars(mine).items():
        if dataclasses.is_dataclass(val):
            _copy_into(val, getattr(theirs, key))
        else:
            setattr(mine, key, getattr(theirs, key))


def _data(num_train=256):
    data = jax_synthetic_mind(num_news=64, num_train=num_train, num_valid=64, title_len=12,
                              his_len_range=(2, 10), seed=0, popular_frac=0.2)
    toks = np.random.default_rng(1).standard_normal((64, 12, 48)).astype(np.float32)
    return data, toks


def _cfgs(pop: int, slots: int, rounds: int, snap: str = "", **over):
    jcfg = _set(JaxConfig(), {**_SMALL, "fed.num_clients": slots, "fed.rounds": rounds,
                              "train.snapshot_dir": snap, "fed.population.num_clients": pop,
                              **over})
    pcfg = ExperimentConfig()
    for section in ("data", "model", "optim", "fed", "train", "chaos"):
        _copy_into(getattr(pcfg, section), getattr(jcfg, section))
    return jcfg, pcfg


def _port_trainer(pop=0, slots=4, rounds=3, snap="", num_train=256, **over) -> Trainer:
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    _, pcfg = _cfgs(pop, slots, rounds, snap, **over)
    data, toks = _data(num_train)
    return Trainer(pcfg, data, toks, snapshot_dir=snap or None, device="cpu")


def _bits(t: Trainer) -> list:
    return [p.detach().clone() for st in t.states for p in st.model.parameters()]


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def run_against_jax(pop: int, slots: int, rounds: int, **over):
    """The JAX ``Trainer`` and the port's from the JAX run's initial
    parameters, round by round through ``train_round_recovering``; returns
    both trainers and their round results."""
    from fedrec_tpu.obs import MetricsRegistry as JaxRegistry
    from fedrec_tpu.obs import Tracer as JaxTracer
    from fedrec_tpu.obs import set_registry as jax_set_registry
    from fedrec_tpu.obs import set_tracer as jax_set_tracer
    from fedrec_tpu.train.trainer import Trainer as JaxTrainer

    import jax

    jax_set_registry(JaxRegistry())
    jax_set_tracer(JaxTracer())
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    jcfg, pcfg = _cfgs(pop, slots, rounds, **over)
    data, toks = _data()
    jt = JaxTrainer(jcfg, data, toks)
    pt = Trainer(pcfg, data, toks, device="cpu")
    up, np_ = jax.tree_util.tree_map(np.asarray, jt._client0_params())
    pt.set_global_params(up, np_)
    results = [(jt.train_round_recovering(r), pt.train_round_recovering(r))
               for r in range(rounds)]
    return jt, pt, results


# the leaves whose true gradient is zero (a softmax is shift-invariant in
# them): their steps are rounding noise that Adam normalizes to full steps
NOISE_LEAVES = ("w_k.bias", "att_fc2.bias")


def assert_slots_close(pt, jt, noise_bar: float = 1e-3) -> None:
    """Every slot's parameters at the trajectory bars (rtol 2e-4, atol
    1e-4), the zero-gradient leaves within ``noise_bar``."""
    def walk(got, want, path=""):
        for key, sub in want.items():
            where = f"{path}.{key}" if path else key
            if isinstance(sub, dict):
                walk(got[key], sub, where)
            elif where.endswith(NOISE_LEAVES):
                assert float(np.abs(got[key] - sub).max()) < noise_bar, where
            else:
                np.testing.assert_allclose(got[key], sub, rtol=2e-4, atol=1e-4, err_msg=where)

    for c in range(len(pt.states)):
        walk(_to_flax(pt.states[c].model), _client_tree(jt.state, c))


def assert_runs_match(jt, pt, results, noise_bar: float = 1e-3) -> None:
    assert pt.cohort_history == jt.cohort_history
    if jt.population is not None:
        _eq_tree(pt.population.ledger.state_dict(), jt.population.ledger.state_dict())
        _eq_tree(pt.cohort_sampler.state_dict(), jt.cohort_sampler.state_dict())
    for jr, pr in results:
        np.testing.assert_allclose(pr.train_loss, jr.train_loss, rtol=1e-5, atol=1e-6,
                                   err_msg=f"round {pr.round_idx}")
    assert_slots_close(pt, jt, noise_bar)


_SAMPLED = {"chaos.enabled": True, "chaos.pop_drop_rate": 0.2,
            "fed.population.over_select": 1.5, "fed.population.sampler": "skew",
            "fed.population.seed": 7}


def test_sampled_run_matches_jax():
    """Population 16 over 4 slots, 4 rounds, population dropout and
    over-selection: the same cohorts, ledger and sampler state exactly, the
    round losses and every slot's parameters at the trajectory bars."""
    jt, pt, results = run_against_jax(16, 4, 4, **_SAMPLED)
    assert pt.registry.counter("fed.cohort_slot_swaps_total").value() > 0
    assert_runs_match(jt, pt, results)


def test_decoupled_sampled_run_matches_jax():
    jt, pt, results = run_against_jax(16, 4, 2, **{**_SAMPLED,
                                                   "model.text_encoder_mode": "table"})
    assert_runs_match(jt, pt, results)


def test_degenerate_population_is_bitwise_no_population():
    """population == slots: identity cohorts, nothing swapped, bitwise the
    run without a population (JAX: test_degenerate_population_bit_identical_host_driven)."""
    t0 = _port_trainer(pop=0)
    h0 = t0.run()
    t1 = _port_trainer(pop=4)
    h1 = t1.run()
    assert [r.train_loss for r in h0] == [r.train_loss for r in h1]
    assert _same_bits(_bits(t0), _bits(t1))
    assert t1.cohort_history == [(r, (0, 1, 2, 3)) for r in range(3)]
    assert t1.registry.counter("fed.cohort_slot_swaps_total").value() == 0


_CHAOS = {"chaos.enabled": True, "chaos.pop_drop_rate": 0.3, "chaos.pop_straggle_ms": 50.0,
          "fed.population.over_select": 1.5, "fed.population.round_deadline_ms": 200.0,
          "fed.population.min_reports": 1, "fed.population.seed": 7,
          "model.dropout_rate": 0.2}


def test_sampled_run_counts_events_and_replays_bitwise():
    t0 = _port_trainer(pop=32, rounds=4, **_CHAOS)
    t0.run()
    reg = t0.registry
    assert reg.gauge("fed.population_clients").value() == 32.0
    assert reg.counter("fed.pop_dropouts_total").value() > 0
    assert reg.counter("fed.cohort_slot_swaps_total").value() > 0
    assert 0 < reg.gauge("fed.population_coverage").value() <= 1.0
    assert len(t0.cohort_history) == 4
    t1 = _port_trainer(pop=32, rounds=4, **_CHAOS)
    t1.run()
    assert t0.cohort_history == t1.cohort_history
    assert _same_bits(_bits(t0), _bits(t1))


def test_resume_with_spilled_sidecars_is_bitwise(tmp_path):
    """persist mode with two resident sidecars: 3 rounds, then a resume to
    6, equals the straight 6-round run bitwise (parameters, the sampler, the
    ledger and every stored sidecar); the JAX package resumes the schedule
    only (its sidecars restart from the template)."""
    kw = {**_CHAOS, "fed.population.sampler": "skew", "fed.population.resident_cap": 2}
    ta = _port_trainer(pop=32, rounds=6, snap=str(tmp_path / "a"), **kw)
    ta.run()
    assert ta.population.spill_count > 0
    tb = _port_trainer(pop=32, rounds=3, snap=str(tmp_path / "b"), **kw)
    tb.run()
    tc = _port_trainer(pop=32, rounds=6, snap=str(tmp_path / "b"), **kw)
    assert tc.start_round == 3
    tc.run()
    assert tb.cohort_history + tc.cohort_history == ta.cohort_history
    assert _same_bits(_bits(ta), _bits(tc))
    _eq_tree(tc.cohort_sampler.state_dict(), ta.cohort_sampler.state_dict())
    _eq_tree(tc.population.ledger.state_dict(), ta.population.ledger.state_dict())
    assert tc.population.stored_ids() == ta.population.stored_ids()
    for cid in ta.population.stored_ids():
        a, c = ta.population.get_sidecar(cid), tc.population.get_sidecar(cid)
        for key in a:
            for x, y in zip(a[key] if isinstance(a[key], list) else [a[key]],
                            c[key] if isinstance(c[key], list) else [c[key]]):
                _eq(x, y)


def test_quorum_discards_round_and_exhaustion_aborts():
    t = _port_trainer(pop=32, rounds=2, **{
        "chaos.enabled": True, "chaos.pop_drop_rate": 0.97, "fed.population.min_reports": 4,
        "fed.population.quorum_retries": 2, "fed.population.seed": 1})
    with pytest.raises(RuntimeError, match="failed quorum") as e:
        t.run()
    assert "retries skipped" not in str(e.value)
    assert t.registry.counter("fed.quorum_replays_total").value() == 3
    assert t.cohort_sampler.rounds_committed == 0 and t.cohort_history == []
    assert any(ev["name"] == "quorum_replay" for ev in t.tracer._events)


def test_quorum_replay_recovers_with_a_fresh_draw():
    t = _port_trainer(pop=32, rounds=3, **{
        "chaos.enabled": True, "chaos.pop_drop_rate": 0.5, "fed.population.min_reports": 4,
        "fed.population.seed": 3, "fed.population.quorum_retries": 50})
    t.run()
    assert t.registry.counter("fed.quorum_replays_total").value() > 0
    assert [r for r, _ in t.cohort_history] == [0, 1, 2]
    assert all(len(c) >= 4 for _, c in t.cohort_history)


def test_quorum_without_attempt_sensitive_dice_fails_fast():
    t = _port_trainer(pop=4, rounds=2, **{
        "fed.participation": 0.5, "fed.population.min_reports": 4,
        "fed.population.quorum_retries": 3})
    with pytest.raises(RuntimeError, match="retries skipped"):
        t.run()
    assert t.registry.counter("fed.quorum_replays_total").value() == 1


def test_rollback_quarantines_the_logical_client_and_resets_its_sidecar():
    """JAX: test_rollback_quarantine_resets_sidecar_for_good. Then a whole
    run: a NaN in slot 1 at round 2 quarantines that round's logical client
    and resets its sidecar, and the replay draws a cohort without it. The
    fault is keyed on the slot, as in the JAX package, so each replay's new
    occupant of slot 1 meets it too and is quarantined in turn, until the
    retries are spent and the run aborts, as the JAX trainer does."""
    from fedrec_tpu_torch.obs import TrainingHealthError

    t = _port_trainer(pop=32, rounds=1, **{"fed.robust.recover": True,
                                           "fed.robust.quarantine_rounds": 2})
    t._ensure_cohort(0)
    logical = int(t._current_plan.slot_clients[0])
    t._capture_recovery_state()
    t.population.put_sidecar(logical, t._template_sidecar(logical))
    t._rollback_and_quarantine({"client": 0, "kind": "nonfinite", "round": 0}, 0)
    assert t.population.get_sidecar(logical) is None
    assert not t._slot_writeback[t._slot_occupants == logical].any()
    t._ensure_cohort(0)
    assert logical not in set(t._current_plan.slot_clients.tolist())
    assert t.population.get_sidecar(logical) is None

    over = {"fed.robust.recover": True, "fed.robust.quarantine_rounds": 2,
            "chaos.enabled": True, "chaos.faults": "nan@2:1"}
    t = _port_trainer(pop=32, rounds=5, **over)
    drawn = []
    install = t._install_cohort
    t._install_cohort = lambda plan: (drawn.append(plan.slot_clients.copy()), install(plan))
    with pytest.raises(TrainingHealthError, match="nonfinite"):
        t.run()
    victims = [ev["args"]["client"] for ev in t.tracer._events if ev["name"] == "rollback"]
    assert len(victims) == 2 and [r for r, _ in t.cohort_history] == [0, 1]
    # each victim sat in slot 1 of a round-2 draw, and no later draw holds it
    assert [int(d[1]) for d in drawn[2:4]] == victims
    assert victims[0] not in drawn[3] and not set(victims) & set(drawn[4].tolist())
    assert all(t.population.get_sidecar(v) is None for v in victims)
    assert sorted(t.population.ledger.quarantined) == sorted(victims)


def test_install_preserves_sidecar_of_client_repacked_to_new_slot():
    t = _port_trainer(pop=8, slots=4)

    def plan(clients, real):
        c = np.asarray(clients, np.int64)
        return ppop.CohortPlan(round_idx=0, attempt=0, sampled=np.unique(c),
                               start_dropped=np.zeros((0,), np.int64), slot_clients=c,
                               slot_real=np.asarray(real, bool))

    t._install_cohort(plan([0, 1, 2, 3], [True] * 4))
    t.states[3].step = 7  # "train" client 3 in slot 3
    t._install_cohort(plan([3, 4, 5, 3], [True, True, True, False]))
    assert t.states[0].step == 7


def test_degenerate_slot_chaos_lands_in_the_ledger():
    t = _port_trainer(pop=4, rounds=3, **{"chaos.enabled": True, "chaos.drop_rate": 0.5,
                                          "chaos.seed": 2})
    t.run()
    led = t.population.ledger
    assert t.registry.counter("fed.pop_dropouts_total").value() > 0
    assert led.selected.sum() == led.reported.sum() + led.dropped.sum() + led.deadline_cut.sum()


def test_population_validation_errors():
    with pytest.raises(ValueError, match="below the device-slot count"):
        _port_trainer(pop=2)
    with pytest.raises(ValueError, match="over_select"):
        _port_trainer(pop=8, **{"fed.population.over_select": 0.9})
    with pytest.raises(ValueError, match="client_state"):
        _port_trainer(pop=8, **{"fed.population.client_state": "pause"})
    with pytest.raises(ValueError, match="min_reports"):
        _port_trainer(pop=8, **{"fed.population.min_reports": 5})
    with pytest.raises(ValueError, match="param-syncing strategy"):
        _port_trainer(pop=8, **{"fed.strategy": "local"})
    with pytest.raises(ValueError, match="fed.participation"):
        _port_trainer(pop=8, **{"fed.participation": 0.5})
    with pytest.raises(ValueError, match="unknown fed.population.sampler"):
        _port_trainer(pop=8, **{"fed.population.sampler": "lottery"})
    with pytest.raises(ValueError, match="smaller than data.batch_size"):
        _port_trainer(pop=64)


@pytest.mark.parametrize("key,value", [("pop_drop_rate", 0.3), ("pop_flaky_fraction", 0.5),
                                       ("pop_straggle_ms", 30.0)])
def test_population_chaos_keys_run(key, value):
    """The pop_* keys the port used to refuse now run through the cohort
    engine."""
    t = _port_trainer(pop=16, rounds=2, **{"chaos.enabled": True, f"chaos.{key}": value,
                                           "fed.population.round_deadline_ms": 40.0,
                                           "fed.population.over_select": 1.5})
    hist = t.run()
    assert len(hist) == 2 and all(np.isfinite(r.train_loss) for r in hist)


def test_population_config_accepts_the_cli_spelling():
    cfg = ExperimentConfig().apply_overrides([
        "fed.population.num_clients=256", "fed.population.sampler=skew",
        "fed.population.over_select=1.25", "fed.population.resident_cap=8",
        "chaos.pop_straggle_sigma=0.5", "data.shuffle=false", "data.seed=3",
        "data.drop_remainder=0", "data.prefetch_batches=2", "data.num_shards=2",
        "data.shard_index=1"])
    pop, d = cfg.fed.population, cfg.data
    assert (pop.num_clients, pop.sampler, pop.over_select, pop.resident_cap) == (
        256, "skew", 1.25, 8)
    assert (d.shuffle, d.seed, d.drop_remainder, d.prefetch_batches, d.num_shards,
            d.shard_index) == (False, 3, False, 2, 2, 1)
    assert cfg.chaos.pop_straggle_sigma == 0.5
    # every field with the JAX package's default
    for mine, theirs in ((cfg.fed.population.__class__(), JaxConfig().fed.population),
                         (cfg.fed.elastic.__class__(), JaxConfig().fed.elastic)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_run_cli_runs_a_sampled_fedadam_population(capsys):
    """The run CLI takes the cohort engine's, FedOpt's and the data path's
    ``--set`` keys (no flags of their own, as in the JAX CLI)."""
    from fedrec_tpu_torch.cli.run import main

    rc = main(["2", "8", "1", "--synthetic", "--device", "cpu", "--clients", "2",
               "--synthetic-train", "256", "--synthetic-news", "128", "--mode", "joint",
               *[x for kv in ("model.news_dim=32", "model.num_heads=4", "model.head_dim=8",
                              "model.query_dim=16", "model.bert_hidden=48",
                              "train.snapshot_dir=", "fed.population.num_clients=8",
                              "fed.population.sampler=weighted", "fed.server_opt=adam",
                              "fed.server_lr=0.01", "chaos.enabled=1",
                              "chaos.pop_drop_rate=0.2", "data.prefetch_batches=2",
                              "data.shuffle=false", "data.num_shards=2", "data.shard_index=1")
                 for x in ("--set", kv)]])
    out = capsys.readouterr().out
    assert rc == 0 and "final: loss=" in out
