"""The port's fleet layer (``obs.fleet``) against the JAX package's (CPU): the
identity stamps, the merger (clock offsets, critical path, the fleet report
and its text) on the same synthetic ``worker_*`` dirs drawn from a numpy
seed, each package's merger on the other's artifacts, the collector and the
pusher both ways, the counter baseline both ways, the standalone collector
with its fleet rules, the ``fedrec-obs`` fleet verbs, and the modules'
torch-free import.

The synthetic fleet: three barrier workers with a known clock skew
(worker 1 +3.5 s) and a known straggler (worker 2's rounds 3x longer), an
async commit authority that shares no round and is placed by the wire
offsets its clients measured, and a membership service.

Tolerances: offsets, critical paths and reports are compared as JSON with
floats within 1e-9 relative (the same float64 arithmetic; JSON's repr
round-trips them exactly, so they come out equal); the rendered text is
compared exactly.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from fedrec_tpu.cli import obs as jobs_cli
from fedrec_tpu.obs import fleet as jfleet
from fedrec_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fedrec_tpu.obs.tracing import Tracer as JaxTracer
from fedrec_tpu_torch.cli import obs as obs_cli
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, fleet, set_registry, set_tracer
from fedrec_tpu_torch.obs.report import load_jsonl
from fedrec_tpu_torch.utils.logging import MetricLogger

ROOT = Path(__file__).resolve().parents[1]
BASE = 1_700_000_000.0


@pytest.fixture
def fresh_obs():
    prev_r, prev_t = set_registry(MetricsRegistry()), set_tracer(Tracer())
    fleet.reset_fleet_identity()
    jfleet.reset_fleet_identity()
    yield
    fleet.reset_fleet_identity()
    jfleet.reset_fleet_identity()
    set_registry(prev_r)
    set_tracer(prev_t)


def _wait_until_it_answers(port: int, cmd: str, timeout_s: float = 60.0) -> None:
    """Poll a service just started in a process of its own until it answers
    ``cmd``: a loaded machine can take seconds to start an interpreter."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fleet.request_json_line("127.0.0.1", port, {"cmd": cmd}, 2.0)
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _close(a, b, path="") -> None:
    """JSON-shaped equality, floats within 1e-9 relative."""
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------- identity
def test_identity_stamps_spans_snapshots_and_records_as_jax(fresh_obs, tmp_path):
    """The same identity in both packages gives the same ``fleet`` key, span
    args and record keys; without one nothing is stamped."""
    outs = []
    for mod, Reg, Tr, Logger in ((fleet, MetricsRegistry, Tracer, MetricLogger),
                                 (jfleet, JaxRegistry, JaxTracer, None)):
        reg, tr = Reg(), Tr()
        assert mod.set_fleet_identity("4", rank=2, epoch=7, registry=reg, tracer=tr) == {
            "worker": "4", "rank": 2, "membership_epoch": 7}
        assert mod.ensure_fleet_identity("9") == {"worker": "4", "rank": 2,
                                                  "membership_epoch": 7}
        with tr.span("fed_round", step_num=3):
            pass
        if Logger is None:
            from fedrec_tpu.utils.logging import MetricLogger as Logger
            logger = Logger(jsonl_path=str(tmp_path / "j.jsonl"), registry=reg)
        else:
            logger = Logger(jsonl_path=str(tmp_path / "p.jsonl"), registry=reg)
        record = logger.log(1, {"loss": 0.5, "worker": "explicit"}) or json.loads(
            (tmp_path / "j.jsonl").read_text().splitlines()[-1])
        outs.append((reg.snapshot()["fleet"], tr.events()[-1]["args"],
                     {k: v for k, v in record.items() if k != "elapsed_sec"}))
        mod.reset_fleet_identity()
        assert mod.get_fleet_identity() == {}
    assert outs[0] == outs[1]
    assert outs[0][2]["worker"] == "explicit" and outs[0][2]["rank"] == 2
    reg, tr = MetricsRegistry(), Tracer()
    with tr.span("x"):
        pass
    assert "args" not in tr.events()[-1] and "fleet" not in reg.snapshot()


# ------------------------------------------------------ the synthetic fleet
def _hist(sum_, count):
    return {"sum": sum_, "count": count, "buckets": {"+Inf": count}}


def _write_fleet(root: Path, seed: int) -> None:
    """Worker dirs as JSON files (neither package's writer): metrics.jsonl
    with records, alert records and a last registry snapshot; trace.json
    with ``fed_round`` and phase spans and the tracer's wall anchor."""
    rng = np.random.default_rng(seed)
    rounds = 6
    skews = {"0": 0.0, "1": 3.5, "2": -0.8}
    for wid in ("0", "1", "2"):
        events = []
        for r in range(rounds):
            start = r * 1.0 + skews[wid] + float(rng.uniform(0, 0.003))
            dur = float(rng.uniform(0.20, 0.25) * (3.0 if wid == "2" else 1.0))
            for name, frac in (("batch_build", 0.1), ("dispatch", 0.6), ("aggregate", 0.2)):
                events.append({"name": name, "ph": "X", "ts": (start + 0.01) * 1e6,
                               "dur": dur * frac * 1e6, "pid": 1, "tid": 1})
            events.append({"name": "fed_round", "ph": "X", "ts": start * 1e6, "dur": dur * 1e6,
                           "pid": 1, "tid": 1, "args": {"step_num": r, "worker": wid}})
        offs = {"aggserver": 250.0 + (skews["0"] - skews[wid]) * 1e3
                + float(rng.uniform(-2, 2))}
        rtt = float(rng.uniform(1.0, 3.0))
        metrics = {
            "train.rounds_total": {"kind": "counter", "help": "", "values": [
                {"labels": {}, "value": float(rounds)}]},
            "train.round_loss": {"kind": "gauge", "help": "", "values": [
                {"labels": {}, "value": float(rng.uniform(0.5, 1.0))}]},
            "fed.dcn_bytes_up_total": {"kind": "counter", "help": "", "values": [
                {"labels": {"path": "dcn"}, "value": float(rng.integers(1e6, 5e6))}]},
            "fed.dcn_bytes_down_total": {"kind": "counter", "help": "", "values": [
                {"labels": {"path": "dcn"}, "value": float(rng.integers(1e6, 5e6))}]},
            "agg.adopted_version": {"kind": "gauge", "help": "", "values": [
                {"labels": {}, "value": 5.0}]},
            "wire.requests_total": {"kind": "counter", "help": "", "values": [
                {"labels": {"peer": "aggserver", "op": op}, "value": float(n)}
                for op, n in (("push", rounds), ("global", 2 * rounds))]},
            "wire.errors_total": {"kind": "counter", "help": "", "values": [
                {"labels": {"peer": "aggserver", "op": "push"}, "value": 1.0}]},
            "wire.bytes_sent_total": {"kind": "counter", "help": "", "values": [
                {"labels": {"peer": "aggserver", "op": "push"}, "value": 6.2e6 * rounds}]},
            "wire.rtt_ms": {"kind": "histogram", "help": "", "values": [
                {"labels": {"peer": "aggserver", "op": op}, **_hist(rtt * n * k, n)}
                for op, n, k in (("push", rounds, 40.0), ("global", 2 * rounds, 1.0))]},
            "wire.server_ms": {"kind": "histogram", "help": "", "values": [
                {"labels": {"peer": "aggserver", "op": "push"},
                 **_hist(0.8 * rtt * rounds * 40.0, rounds)}]},
            "wire.clock_offset_ms": {"kind": "gauge", "help": "", "values": [
                {"labels": {"peer": p}, "value": v} for p, v in offs.items()]},
            "perf.samples_per_sec": {"kind": "gauge", "help": "", "values": [
                {"labels": {}, "value": float(rng.uniform(100, 200))}]},
        }
        _write_worker(root / f"worker_{wid}", BASE, events, metrics,
                      {"worker": wid, "rank": int(wid)}, rng, alerts=wid == "2")
    # the authority: no fed_round; its clock 250 ms ahead of worker 0's
    a_events = []
    for v in range(1, 6):
        t = v * 1.0 + 0.9 + 0.25
        a_events += [{"name": "wire.serve", "ph": "X", "ts": t * 1e6, "dur": 2e3, "pid": 9,
                      "tid": 2, "args": {"op": "push", "peer": "0"}},
                     {"name": "agg.commit", "ph": "X", "ts": (t + 0.01) * 1e6, "dur": 50e3,
                      "pid": 9, "tid": 2, "args": {"quorum": 2}}]
    a_metrics = {
        "agg.commits_total": {"kind": "counter", "help": "", "values": [
            {"labels": {}, "value": 5.0}]},
        "agg.late_folds_total": {"kind": "counter", "help": "", "values": [
            {"labels": {}, "value": 2.0}]},
        "agg.global_version": {"kind": "gauge", "help": "", "values": [
            {"labels": {}, "value": 5.0}]},
        "agg.quorum_wait_ms": {"kind": "gauge", "help": "", "values": [
            {"labels": {}, "value": float(rng.uniform(100, 900))}]},
        "agg.commit_fold_ms": {"kind": "gauge", "help": "", "values": [
            {"labels": {}, "value": float(rng.uniform(20, 90))}]},
        "agg.worker_gate_ms": {"kind": "gauge", "help": "", "values": [
            {"labels": {"worker": w}, "value": float(g)}
            for w, g in (("0", 12.5), ("1", 0.0), ("2", 0.0))]},
        "wire.requests_total": {"kind": "counter", "help": "", "values": [
            {"labels": {"peer": w, "op": "push"}, "value": 6.0} for w in ("0", "1", "2")]},
    }
    _write_worker(root / "worker_aggserver", BASE, a_events, a_metrics,
                  {"worker": "aggserver"}, rng)
    # the membership service, its formations on its own raw wall anchor
    m_events = [{"name": "membership_epoch_formed", "ph": "i", "s": "t", "ts": t * 1e6,
                 "pid": 5, "tid": 1, "args": {"epoch": e, "world": w}}
                for t, e, w in ((0.1, 1, 3), (2.5, 2, 2), (4.0, 3, 3))]
    m_metrics = {name: {"kind": kind, "help": "", "values": [{"labels": {}, "value": v}]}
                 for name, kind, v in (("fed.membership_epoch", "gauge", 3.0),
                                       ("fed.membership_world", "gauge", 3.0),
                                       ("fed.membership_shrinks_total", "counter", 1.0),
                                       ("fed.membership_rejoins_total", "counter", 1.0),
                                       ("fed.membership_lease_misses_total", "counter", 1.0))}
    _write_worker(root / "worker_membership", BASE + 0.05, m_events, m_metrics,
                  {"worker": "membership"}, rng)
    # the collector's fleet rules
    fdir = root / "worker_fleet"
    fdir.mkdir()
    with open(fdir / "metrics.jsonl", "w") as f:
        for i, (key, ev) in enumerate((("fleet:straggler:2", "firing"),
                                       ("fleet:world_below_target", "firing"),
                                       ("fleet:world_below_target", "resolved"))):
            f.write(json.dumps({"kind": "alert", "event": ev, "ts": BASE + 10 + i, "key": key,
                                "severity": "warning", "summary": f"{key} {ev}",
                                "labels": {"worker": "fleet"}}) + "\n")


def _write_worker(d: Path, epoch_unix: float, events, metrics, ident, rng, alerts=False):
    d.mkdir(parents=True)
    lines = [{"step": 0, "elapsed_sec": 0.1, **ident, "training_loss": float(rng.random())}]
    if alerts:
        lines += [{"kind": "alert", "event": "firing", "ts": BASE + 3, "key": "slo:round_time",
                   "severity": "critical", "summary": "SLO round_time burning",
                   "labels": {"slo": "round_time"}}]
    lines.append({"kind": "registry_snapshot", "ts": BASE + 6, "fleet": ident,
                  "metrics": metrics})
    (d / "metrics.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))
    (d / "trace.json").write_text(json.dumps({
        "traceEvents": events, "displayTimeUnit": "ms",
        "otherData": {"epoch_unix": epoch_unix, "dropped_events": 0}}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merger_equals_jax_on_a_synthetic_fleet(tmp_path, seed):
    _write_fleet(tmp_path, seed)
    ours, theirs = fleet.load_fleet_dir(tmp_path), jfleet.load_fleet_dir(tmp_path)
    assert sorted(ours) == sorted(theirs) == ["0", "1", "2", "aggserver", "fleet", "membership"]
    offsets = fleet.estimate_clock_offsets(ours)
    _close({f"{k[0]}/{k[1]}": v for k, v in offsets.items()},
           {f"{k[0]}/{k[1]}": v for k, v in jfleet.estimate_clock_offsets(theirs).items()})
    # the known skews, and the authority (its clock 250 ms ahead of worker
    # 0's) placed by the wire: it shares no round
    assert abs(offsets[("1", 0)] + 3.5) < 0.01 and abs(offsets[("2", 0)] - 0.8) < 0.01
    assert abs(offsets[("aggserver", 0)] + 0.25) < 0.01
    assert offsets[("membership", 0)] == 0.0
    _close(fleet.wire_edge_offsets(ours), jfleet.wire_edge_offsets(theirs))
    crit = fleet.attribute_critical_path(ours)
    _close(crit, jfleet.attribute_critical_path(theirs))
    assert {row["critical_worker"] for row in crit} == {"2"}
    assert all(row["phase"] == "dispatch" for row in crit)
    report = fleet.build_fleet_report(ours)
    theirs_report = jfleet.build_fleet_report(theirs)
    _close(json.loads(json.dumps(report)), json.loads(json.dumps(theirs_report)))
    assert {"membership", "rounds", "critical_path", "dcn_bytes", "perf", "agg", "wire",
            "alerts"} <= set(report)
    assert report["agg"]["aggserver"]["role"] == "agg_server"
    assert report["wire"]["slowest_edge"]["op"] == "push"
    assert [a["key"] for a in report["alerts"]["active"]] == ["slo:round_time",
                                                              "fleet:straggler:2"]
    assert fleet.render_fleet_text(report) == jfleet.render_fleet_text(theirs_report)
    for section in ("## Alerts", "## Membership", "## Critical path", "## Aggregation",
                    "## Wire", "clock offsets"):
        assert section in fleet.render_fleet_text(report)
    doc = fleet.build_fleet_trace(ours)
    jdoc = jfleet.build_fleet_trace(theirs)
    assert doc["traceEvents"] == jdoc["traceEvents"]
    assert doc["otherData"]["clock_offsets_s"] == jdoc["otherData"]["clock_offsets_s"]


def _write_with(tmp_path: Path, which: str) -> None:
    """Two workers and an authority through one package's writers: its
    tracer (spans, flows, the wall anchor), registry (snapshots with the
    fleet key) and ``dump_artifacts``; an elastic worker's tagged trace."""
    if which == "port":
        mod, Reg, Tr = fleet, MetricsRegistry, Tracer
        from fedrec_tpu_torch.obs.report import dump_artifacts
    else:
        mod, Reg, Tr = jfleet, JaxRegistry, JaxTracer
        from fedrec_tpu.obs.report import dump_artifacts
    for wid, slow in (("0", 1.0), ("1", 4.0), ("aggserver", None)):
        reg, tr = Reg(), Tr()
        mod.set_fleet_identity(wid, rank=None if slow is None else int(wid), registry=reg,
                               tracer=tr)
        reg.counter("train.rounds_total").inc(3)
        reg.gauge("wire.clock_offset_ms", labels=("peer",)).set(0.5, peer="aggserver")
        for r in range(3):
            if slow is None:
                with tr.span("agg.commit", quorum=2):
                    tr.flow("in", 100 + r)
                    time.sleep(0.001)
                continue
            end = tr.now()
            tr.add_span("fed_round", 0.002 * slow, end=end, step_num=r)
            tr.flow("out", 100 + r, ts=end - 0.001)
        dump_artifacts(tmp_path / f"worker_{wid}", registry=reg, tracer=tr,
                       trace_tag="e1" if wid == "1" else None)
        mod.reset_fleet_identity()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_merger_reads_the_others_artifacts(tmp_path, fresh_obs, writer):
    _write_with(tmp_path, writer)
    ours, theirs = fleet.load_fleet_dir(tmp_path), jfleet.load_fleet_dir(tmp_path)
    assert sorted(ours) == ["0", "1", "aggserver"]
    assert [t.tag for t in ours["1"].traces] == ["e1"]
    _close(json.loads(json.dumps(fleet.build_fleet_report(ours))),
           json.loads(json.dumps(jfleet.build_fleet_report(theirs))))
    assert fleet.render_fleet_text(fleet.build_fleet_report(ours)) == jfleet.render_fleet_text(
        jfleet.build_fleet_report(theirs))
    doc, jdoc = fleet.build_fleet_trace(ours), jfleet.build_fleet_trace(theirs)
    assert doc["traceEvents"] == jdoc["traceEvents"]
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "wire"]
    assert sorted((e["ph"], e["args"]["worker"]) for e in flows) == sorted(
        [("s", "0")] * 3 + [("s", "1")] * 3 + [("f", "aggserver")] * 3)


# ------------------------------------------------- collector and pusher
@pytest.mark.parametrize("pusher,collector", [("port", "port"), ("jax", "port"),
                                              ("port", "jax")])
def test_pusher_and_collector_interoperate(tmp_path, fresh_obs, pusher, collector):
    """Pushes are incremental and disjoint (no span twice), the collector's
    dir is the offline layout either merger reads, and the alert records
    of a pushing watch ride along."""
    pmod = fleet if pusher == "port" else jfleet
    cmod = fleet if collector == "port" else jfleet
    Reg, Tr = (MetricsRegistry, Tracer) if pusher == "port" else (JaxRegistry, JaxTracer)
    srv = cmod.CollectorServer(cmod.TelemetryCollector(tmp_path)).start()
    try:
        reg, tr = Reg(), Tr()
        pmod.set_fleet_identity("3", rank=1, registry=reg, tracer=tr)
        p = pmod.FleetPusher(srv.address, registry=reg, tracer=tr)
        engine_mod = __import__(("fedrec_tpu_torch" if pusher == "port" else "fedrec_tpu")
                                + ".obs.alerts", fromlist=["AlertEngine"])
        p.engine = engine_mod.AlertEngine(registry=reg, tracer=tr, pending_for=1)
        for r in range(3):
            with tr.span("fed_round", step_num=r):
                reg.counter("train.rounds_total").inc()
            if r == 1:
                p.engine.observe("slo:x", True, summary="x")
            assert p.maybe_push(r) is True
        assert p.push(final=True)
        status = srv.collector.status()
    finally:
        srv.stop()
        pmod.reset_fleet_identity()
    # three rounds' spans and the alert's instant
    assert status["pushes"] == 4 and status["workers"]["3"]["events"] == 4
    for mod in (fleet, jfleet):
        workers = mod.load_fleet_dir(tmp_path)
        w = workers["3"]
        assert [e["args"]["step_num"] for t in w.traces for e in t.events
                if e["name"] == "fed_round"] == [0, 1, 2]
        assert len(w.snapshots) == 4 and w.snapshots[-1]["fleet"]["rank"] == 1
        assert [r["key"] for r in w.records if r.get("kind") == "alert"] == ["slo:x"]
        assert mod.build_fleet_report(workers)["alerts"]["active"][0]["key"] == "slo:x"


def test_pusher_counts_failures_never_raises_and_backs_off(fresh_obs):
    import socket

    with socket.create_server(("127.0.0.1", 0)) as s:
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    reg = MetricsRegistry()
    p = fleet.FleetPusher(dead, worker="9", registry=reg, tracer=Tracer(), timeout_s=0.5)
    p._FINAL_RETRY_DELAY_S = 0.0
    assert [p.push() for _ in range(3)] == [False] * 3
    assert p.failures == 3 and p._backoff_until > time.monotonic()
    assert p.push() is False and p.failures == 3  # skipped in the back-off window
    assert p.push(final=True) is False and p.failures == 5  # the final push retries once
    assert reg.snapshot()["metrics"]["obs.fleet_push_failures_total"]["values"][0]["value"] == 5


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_counter_baseline_round_trips_both_ways(tmp_path, saver):
    save_mod = fleet if saver == "port" else jfleet
    load_mod = jfleet if saver == "port" else fleet
    Reg = MetricsRegistry if saver == "port" else JaxRegistry
    LoadReg = JaxRegistry if saver == "port" else MetricsRegistry
    reg = Reg()
    reg.counter("fed.dcn_bytes_up_total", "up", labels=("path", "codec")).inc(
        123.0, path="dcn", codec="int8")
    reg.counter("train.rounds_total").inc(7)
    reg.counter("unused_total").inc(0)
    save_mod.save_counter_baseline(tmp_path, registry=reg, epoch=4)
    assert fleet.counter_baseline(reg) == jfleet.counter_baseline(reg)
    back = LoadReg()
    assert load_mod.restore_counter_baseline(tmp_path, registry=back) == 4
    back.counter("fed.dcn_bytes_up_total", labels=("path", "codec")).inc(
        1.0, path="dcn", codec="int8")
    assert back.counter("fed.dcn_bytes_up_total", labels=("path", "codec")).value(
        path="dcn", codec="int8") == 124.0
    assert back.counter("train.rounds_total").value() == 7.0
    (tmp_path / "counters.json").write_text("{torn")
    assert fleet.restore_counter_baseline(tmp_path, registry=MetricsRegistry()) is None
    assert fleet.restore_counter_baseline(tmp_path / "none") is None


def test_standalone_collector_fires_the_straggler_rule(tmp_path, fresh_obs):
    """``python -m fedrec_tpu_torch.obs.fleet HOST:PORT --dir D --watch
    --straggler-evals 2``: three workers push a snapshot a second, worker 2
    every five; the straggler alert for worker 2 fires in
    ``D/worker_fleet/metrics.jsonl`` and none for the others."""
    from fedrec_tpu_torch.parallel.membership import free_port

    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedrec_tpu_torch.obs.fleet", f"127.0.0.1:{port}", "--dir",
         str(tmp_path), "--watch", "--straggler-evals", "2"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait_until_it_answers(port, "telemetry_status")
        for i in range(4):
            for w in ("0", "1", "2"):
                ts = 100.0 + i * (5.0 if w == "2" else 1.0)
                fleet.request_json_line("127.0.0.1", port, {
                    "cmd": "telemetry_push", "worker": w,
                    "snapshot": {"kind": "registry_snapshot", "ts": ts, "metrics": {}}}, 5.0)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    assert "[collector] listening on" in out and "watch=on" in out
    recs = [r for r in load_jsonl(tmp_path / "worker_fleet" / "metrics.jsonl")[0]
            if r.get("kind") == "alert" and r["event"] == "firing"]
    assert [r["key"] for r in recs] == ["fleet:straggler:2"]
    assert recs[0]["labels"]["signal"] == "push gap"


# ------------------------------------------------------------ the CLI verbs
def test_fleet_verbs_equal_jax(tmp_path, capsys):
    _write_fleet(tmp_path, 3)
    outs = []
    for cli in (obs_cli, jobs_cli):
        for argv in (["fleet", str(tmp_path), "--json"], ["fleet", str(tmp_path)]):
            capsys.readouterr()
            assert cli.main(argv) == 0
            outs.append(capsys.readouterr().out)
        capsys.readouterr()
        # alerts still firing (slo:round_time on worker 2, the fleet straggler)
        assert cli.main(["alerts", str(tmp_path), "--json"]) == 1
        outs.append(json.loads(capsys.readouterr().out))
        assert cli.main(["tail", str(tmp_path), "--once"]) == 1
        outs.append(capsys.readouterr().out)
    assert outs[:4] == outs[4:]
    assert obs_cli.main(["alerts", str(tmp_path / "worker_2")]) == 1
    assert obs_cli.main(["alerts", str(tmp_path / "worker_1")]) == 0
    capsys.readouterr()
    out = tmp_path / "merged.json"
    assert obs_cli.main(["fleet-trace", str(tmp_path), "-o", str(out)]) == 0
    assert "worker track(s)" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["otherData"]["producer"] == "fedrec_tpu_torch.obs.fleet"
    assert set(doc["otherData"]["workers"]) == {"0", "1", "2", "aggserver", "fleet",
                                               "membership"}
    assert obs_cli.main(["fleet", str(tmp_path / "nowhere")]) == 2
    (tmp_path / "empty").mkdir()
    assert obs_cli.main(["fleet", str(tmp_path / "empty")]) == 2


def test_fleet_modules_import_no_torch():
    """The collector, the merger, the watch and ``fedrec-obs`` start in an
    interpreter's time: none of them imports torch (or JAX)."""
    code = ("import sys\n"
            "import fedrec_tpu_torch.obs.fleet, fedrec_tpu_torch.obs.wire\n"
            "import fedrec_tpu_torch.obs.watch, fedrec_tpu_torch.obs.alerts\n"
            "import fedrec_tpu_torch.cli.obs, fedrec_tpu_torch.agg.server\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_membership_service_is_the_collector_with_watch(tmp_path, fresh_obs):
    """``python -m fedrec_tpu_torch.parallel.membership HOST:PORT
    --telemetry-dir D --watch``: pushes on the membership port land in
    ``D/worker_<id>``, and the fleet rules write under ``D/worker_fleet``."""
    from fedrec_tpu_torch.parallel.membership import free_port

    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedrec_tpu_torch.parallel.membership", f"127.0.0.1:{port}",
         "--telemetry-dir", str(tmp_path), "--watch", "--target-world", "3"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait_until_it_answers(port, "status")
        # worker 1 pushes every 5 s, the others every second: three
        # breaching pushes (obs.watch.fleet_straggler_evals) from the third
        for i in range(5):
            for w in ("0", "1", "2"):
                ts = 100.0 + i * (5.0 if w == "1" else 1.0)
                assert fleet.request_json_line("127.0.0.1", port, {
                    "cmd": "telemetry_push", "worker": w,
                    "snapshot": {"kind": "registry_snapshot", "ts": ts, "metrics": {}}},
                    5.0) == {"ok": True, "worker": w}
        status = fleet.request_json_line("127.0.0.1", port, {"cmd": "telemetry_status"}, 5.0)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    assert "[membership] serving on" in out
    assert status["pushes"] == 15 and sorted(status["workers"]) == ["0", "1", "2"]
    assert sorted(fleet.load_fleet_dir(tmp_path)) == ["0", "1", "2", "fleet"]
    fired = [r["key"] for r in load_jsonl(tmp_path / "worker_fleet" / "metrics.jsonl")[0]
             if r.get("kind") == "alert" and r["event"] == "firing"]
    assert fired == ["fleet:straggler:1"]
