"""The port's buffered quorum commit (``agg.mode="async"``:
``fedrec_tpu_torch.agg.buffer``, ``agg.commit`` and the ``Trainer``'s
in-process commit) against the JAX package's (``fedrec_tpu/agg/``,
``tests/test_agg.py``).

* the ``Trainer``: K = 8 slots over a population of 24, 4 rounds, quorum 5
  with seeded report latencies (``chaos.pop_straggle_ms``), staleness caps 1
  and 3, under ``fed.dcn_compress`` none, int8 and countsketch and one
  ``trimmed_mean`` fold, and one under FedAvgM (``fed.server_opt=sgd``,
  momentum 0.9) with persisted client state, from the JAX run's initial
  parameters: round losses
  at rtol 1e-5, every slot's parameters at rtol 2e-4 / atol 1e-4 (the
  ``Trainer`` trajectory bars), and the commit version, late folds, stale
  drops, the gauges and the pending buffer equal;
* all-reporting async (quorum 0, chaos off) against the flat mean, and a
  resumed async run against the straight one, bitwise;
* ``fold_commit`` and ``encode_contribution`` against JAX's on the same
  inputs (the hand-computed staleness fold, the stale drop, an entry from
  the future), and the buffer sidecar read across the packages both ways.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np
import pytest

from fedrec_tpu.agg import buffer as jbuf
from fedrec_tpu.agg import commit as jcommit
from fedrec_tpu_torch.agg import buffer as pbuf
from fedrec_tpu_torch.agg import commit as pcommit
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, set_registry, set_tracer
from fedrec_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_population as tp  # noqa: E402

_COUNTERS = ("agg.commits_total", "agg.late_folds_total", "agg.stale_drops_total")
_GAUGES = ("agg.adopted_version", "agg.staleness", "agg.quorum_wait_ms", "agg.gate_saved_ms",
           "agg.buffer_pending")
_LR = 3e-3  # optim.user_lr / news_lr of the population file's small config


def _cfgs(pop: int, slots: int, rounds: int, snap: str = "", **over):
    jcfg, pcfg = tp._cfgs(pop, slots, rounds, snap, **over)
    tp._copy_into(pcfg.agg, jcfg.agg)
    return jcfg, pcfg


def _run_against_jax(pop: int, slots: int, rounds: int, **over):
    """Both ``Trainer``s from the JAX run's initial parameters, round by
    round; returns them and their round results."""
    import jax
    from fedrec_tpu.obs import MetricsRegistry as JaxRegistry
    from fedrec_tpu.obs import Tracer as JaxTracer
    from fedrec_tpu.obs import set_registry as jax_set_registry
    from fedrec_tpu.obs import set_tracer as jax_set_tracer
    from fedrec_tpu.train.trainer import Trainer as JaxTrainer

    jax_set_registry(JaxRegistry())
    jax_set_tracer(JaxTracer())
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    jcfg, pcfg = _cfgs(pop, slots, rounds, **over)
    data, toks = tp._data()
    jt = JaxTrainer(jcfg, data, toks)
    pt = Trainer(pcfg, data, toks, device="cpu")
    pt.set_global_params(*jax.tree_util.tree_map(np.asarray, jt._client0_params()))
    return jt, pt, [(jt.train_round_recovering(r), pt.train_round_recovering(r))
                    for r in range(rounds)]


_ASYNC = {"chaos.enabled": True, "chaos.pop_straggle_ms": 50.0, "fed.population.seed": 7,
          "agg.mode": "async", "agg.quorum": 5}


# FedAvgM over the commit (``server_opt.step(round-start global, fold)``),
# with each logical client's state persisted, as chip_smoke's async_path runs
_FEDAVGM = {"fed.server_opt": "sgd", "fed.server_lr": 1.0, "fed.server_momentum": 0.9,
            "fed.population.client_state": "persist"}


@pytest.mark.parametrize("cap,codec,method,extra", [
    (1, "none", "mean", {}), (3, "int8", "mean", {}), (1, "countsketch", "mean", {}),
    (3, "none", "trimmed_mean", {}), (3, "none", "mean", _FEDAVGM)],
    ids=["1-none-mean", "3-int8-mean", "1-countsketch-mean", "3-none-trimmed_mean",
         "3-none-mean-fedavgm"])
def test_async_trainer_matches_jax(cap, codec, method, extra):
    over = {**_ASYNC, "agg.staleness_cap": cap, "fed.dcn_compress": codec,
            "fed.robust.method": method, "fed.robust.trim_k": 1, **extra}
    jt, pt, results = _run_against_jax(24, 8, 4, **over)
    assert (pt.server_opt is not None) == (jt.server_opt is not None) == bool(extra)
    assert pt._agg_version == jt._agg_version == 4
    for name in _COUNTERS:
        assert pt.registry.counter(name).value() == jt.registry.counter(name).value(), name
    for name in _GAUGES:
        assert pt.registry.gauge(name).value() == jt.registry.gauge(name).value(), name
    assert pt.registry.counter("agg.late_folds_total").value() > 0
    assert [(e.worker, e.round, e.based_on, e.weight, e.arrival_ms, e.codec)
            for e in pt.agg_buffer.entries] == [
        (e.worker, e.round, e.based_on, e.weight, e.arrival_ms, e.codec)
        for e in jt.agg_buffer.entries]
    # a trimmed mean picks each coordinate by rank, and where every delta
    # is rounding noise (the two zero-gradient leaves) each package ranks
    # its own noise: the pick may differ by up to one Adam step (lr)
    tp.assert_runs_match(jt, pt, results,
                         noise_bar=1e-3 + (_LR if method == "trimmed_mean" else 0.0))


def _port_run(rounds: int, snap: str = "", **over) -> Trainer:
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    _, pcfg = _cfgs(24, 8, rounds, snap, **over)
    data, toks = tp._data()
    return Trainer(pcfg, data, toks, snapshot_dir=snap or None, device="cpu")


def test_all_reporting_async_equals_the_flat_mean():
    """quorum 0 and chaos off: every commit folds every client with no
    staleness, the flat FedAvg mean (``tests/test_agg.py:404``); the fold
    sums in f64 on the host, the flat sync in f32, so allclose 1e-4 (the
    two zero-gradient leaves, whose steps are that rounding noise, within
    the trajectory bars' 1e-3)."""
    flat, a0 = _port_run(3), _port_run(3, **{"agg.mode": "async", "agg.quorum": 0})
    for t in (flat, a0):
        for r in range(3):
            t.train_round_recovering(r)
    assert a0._agg_version == 3 and len(a0.agg_buffer) == 0
    for c in range(8):
        for (name, p), q in zip(flat.states[c].model.named_parameters(),
                                a0.states[c].model.parameters()):
            d = float((p - q).detach().abs().max())
            assert d < (1e-3 if name.endswith(tp.NOISE_LEAVES) else 1e-4), (c, name, d)


def test_resumed_async_run_equals_the_straight_run(tmp_path):
    """2 rounds, a snapshot with pending contributions in the buffer
    sidecar, a resume to 4: bitwise the straight 4-round run (parameters,
    commit version, the buffer)."""
    over = {**_ASYNC, "agg.staleness_cap": 3}
    straight = _port_run(4, **over)
    for r in range(4):
        straight.train_round_recovering(r)
    _port_run(2, str(tmp_path / "s"), **over).run()
    resumed = _port_run(4, str(tmp_path / "s"), **over)
    assert resumed.start_round == 2 and len(resumed.agg_buffer) > 0
    resumed.run()
    assert resumed._agg_version == straight._agg_version == 4
    assert tp._same_bits(tp._bits(resumed), tp._bits(straight))
    for a, b in zip(resumed.agg_buffer.entries, straight.agg_buffer.entries):
        assert (a.worker, a.based_on, a.weight) == (b.worker, b.based_on, b.weight)
        assert all(np.array_equal(x, y) for x, y in zip(a.leaves, b.leaves))


def test_trainer_rejects_bad_async_config():
    for over, msg in (({"agg.staleness_cap": -1}, "staleness_cap"),
                      ({"agg.quorum": 9}, "agg.quorum"),
                      ({"fed.strategy": "grad_avg"}, "requires a strategy that syncs"),
                      ({"fed.dcn_compress": "auto"}, "dcn_compress='auto'")):
        with pytest.raises(ValueError, match=msg):
            _port_run(1, **{"agg.mode": "async", **over})


# ------------------------------------------------------------------ units
def _entries(mod, specs):
    return [mod.BufferEntry(worker=w, round=0, epoch=0, based_on=b, weight=wt, arrival_ms=0.0,
                            leaves=[np.asarray(x) for x in leaves])
            for w, b, wt, leaves in specs]


def _fold_both(base, specs, version, cap=2, **kw):
    out = []
    for mod, commit in ((jbuf, jcommit), (pbuf, pcommit)):
        leaves, stats = commit.fold_commit(base, _entries(mod, specs), version,
                                           commit.CommitPolicy(staleness_cap=cap), **kw)
        out.append(([np.asarray(x) for x in leaves], vars(stats)))
    (jl, js), (pl, ps) = out
    for a, b in zip(pl, jl):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ps.pop("fold_ms"), js.pop("fold_ms")
    assert ps == js
    return pl, ps


def test_fold_commit_matches_jax():
    # fresh delta 2 and a one-commit-stale 0 at weight 1: (1 * 2 + 0.5 * 0) / 1.5
    out, st = _fold_both([np.zeros((1,))], [("fresh", 7, 1.0, [[2.0]]),
                                            ("late", 6, 1.0, [[0.0]])], 7)
    np.testing.assert_allclose(out[0], [4.0 / 3.0], rtol=1e-12)
    assert (st["late_folds"], st["mean_staleness"], st["max_staleness"]) == (1, 0.5, 1)
    # past the cap: dropped; all dropped: the base at the bumped version
    specs = [("ok", 5, 1.0, [[1.0, 1.0]]), ("dead", 2, 1.0, [[99.0, 99.0]])]
    out, st = _fold_both([np.full((2,), 10.0)], specs, 5, cap=1)
    assert st["stale_drops"] == 1 and st["folded"] == 1
    np.testing.assert_allclose(out[0], [11.0, 11.0])
    out, st = _fold_both([np.full((2,), 10.0)], specs[1:], 5, cap=1)
    assert (st["version"], st["folded"]) == (6, 0)
    # the flat weighted mean at no staleness, f32 globals keep their dtype
    rng = np.random.default_rng(2)
    base = [np.zeros((3,), np.float32), np.ones((2, 2), np.float32)]
    _fold_both(base, [(str(i), 5, w, [rng.standard_normal(b.shape) for b in base])
                      for i, w in enumerate((1.0, 2.0, 1.0, 4.0))], 5)
    # a trimmed mean neutralizes a poisoned delta
    out, _ = _fold_both([np.zeros((3,))], [(str(i), 0, 1.0, [np.ones(3)]) for i in range(7)]
                        + [("evil", 0, 1.0, [np.full(3, 1000.0)])], 0,
                        method="trimmed_mean", trim_k=1)
    np.testing.assert_allclose(out[0], np.ones(3))
    for commit, mod in ((jcommit, jbuf), (pcommit, pbuf)):
        with pytest.raises(ValueError, match="ahead of"):
            commit.fold_commit([np.zeros((1,))], _entries(mod, [("w", 9, 1.0, [[1.0]])]), 8,
                               commit.CommitPolicy())
    assert [pcommit.staleness_weight(s) for s in (0, 1, 3)] == [1.0, 0.5, 0.25]
    for q, world in ((6, 8), (6, 4), (0, 5)):
        assert pcommit.CommitPolicy(quorum=q).quorum_for(world) == \
            jcommit.CommitPolicy(quorum=q).quorum_for(world)


@pytest.mark.parametrize("codec", ["int8", "topk", "countsketch", "randproj"])
def test_encode_contribution_and_sketch_fold_match_jax(codec):
    """A contribution through each codec (with a banked residual where the
    codec keeps error feedback), then a commit of two such entries: the
    sketches fold in sketch space and decode once."""
    rng = np.random.default_rng(5)
    shapes = [(40,), (6, 5)]
    base = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    deltas = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
    res = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    kw = dict(topk_ratio=0.2, sketch_width=0.5, sketch_seed=3, residual_leaves=res)
    specs = []
    for i, d in enumerate(deltas):
        j = jcommit.encode_contribution(d, codec, **kw)
        p = pcommit.encode_contribution(d, codec, **kw)
        assert (p[1], p[3]) == (j[1], j[3])
        for a, b in zip(p[0], j[0]):
            np.testing.assert_array_equal(a, b)
        assert (p[2] is None) == (j[2] is None)
        for a, b in zip(p[2] or [], j[2] or []):
            np.testing.assert_array_equal(a, b)
        specs.append((str(i), 0, 1.0 + i, p[0]))
    entries = {mod: _entries(mod, specs) for mod in (jbuf, pbuf)}
    for mod in entries:
        for e in entries[mod]:
            e.codec = p[1]
    got = pcommit.fold_commit(base, entries[pbuf], 0, pcommit.CommitPolicy(), sketch_seed=3)[0]
    want = jcommit.fold_commit(base, entries[jbuf], 0, jcommit.CommitPolicy(), sketch_seed=3)[0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _filled(mod, rng):
    buf = mod.AggBuffer(epoch=5)
    for i in range(3):
        buf.add(mod.BufferEntry(worker=f"w{i}", round=9, epoch=5, based_on=7 + i,
                                weight=1.5 * (i + 1), arrival_ms=10.0 * i,
                                leaves=[rng.standard_normal((4,)),
                                        rng.standard_normal((2, 3)).astype(np.float32)],
                                codec="countsketch" if i == 2 else "none", push_id=f"id{i}"))
    buf.bank_residual("w1", 8, [rng.standard_normal((4,)), np.zeros((2, 3), np.float32)])
    return buf


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_buffer_sidecar_reads_across_packages(writer):
    src_mod, dst_mod = (jbuf, pbuf) if writer == "jax" else (pbuf, jbuf)
    src = _filled(src_mod, np.random.default_rng(3))
    blob = src.state_bytes(round_idx=9, version=8)
    got, round_idx, version = dst_mod.AggBuffer.load_state(blob)
    assert (round_idx, version, got.epoch) == (9, 8, 5)
    for a, b in zip(src.entries, got.entries):
        assert vars(a).keys() == vars(b).keys()
        for key in vars(a):
            if key != "leaves":
                assert getattr(a, key) == getattr(b, key), key
        for x, y in zip(a.leaves, b.leaves):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert got.ef_residuals.keys() == {"w1"} and got.ef_residuals["w1"]["based_on"] == 8
    # the same layout: the npz members and the meta blob are equal
    other = _filled(dst_mod, np.random.default_rng(3)).state_bytes(round_idx=9, version=8)
    with np.load(io.BytesIO(blob)) as a, np.load(io.BytesIO(other)) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_buffer_replaces_a_repush_and_drops_the_dead_on_a_new_epoch():
    def entry(w, r, v):
        return pbuf.BufferEntry(worker=w, round=r, epoch=0, based_on=0, weight=1.0,
                                arrival_ms=0.0, leaves=[np.array([v])])

    buf = pbuf.AggBuffer()
    assert buf.add(entry("w0", 3, 1.0)) is None
    assert float(buf.add(entry("w0", 3, 2.0)).leaves[0][0]) == 1.0  # the retry replaced it
    buf.add(entry("w0", 4, 3.0))
    buf.add(entry("w1", 4, 4.0))
    buf.bank_residual("w1", 0, [np.ones(1)])
    assert len(buf) == 3 and buf.pending_workers() == {"w0", "w1"}
    assert buf.advance_epoch(1, drop_dead={"w1"}) == 1
    assert buf.pending_workers() == {"w0"} and buf.residual_for("w1") is None
    with pytest.raises(ValueError, match="backwards"):
        buf.advance_epoch(0)
    assert len(buf.take_all()) == 2 and len(buf) == 0
    fake = io.BytesIO()
    np.savez(fake, something=np.zeros((2,)))
    with pytest.raises(ValueError, match="agg-buffer"):
        pbuf.AggBuffer.load_state(fake.getvalue())
