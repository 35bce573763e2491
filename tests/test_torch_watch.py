"""The port's watch layer (``obs.watch``, ``obs.alerts``) against the JAX
package's on the same inputs (CPU): the SLO grammar, burn-rate verdicts,
anomaly verdicts, the alert lifecycle's transition records, the watch's
reads of histograms, counters and gauges, and the fleet rules, each over
streams drawn from a numpy seed; then the port's surfaces: the serving
server's ``alerts`` admin command, the ``Trainer``'s round-cadence watch
(``fedrec-obs alerts`` / ``tail --once`` exit 1 while an alert fires, the
report's Alerts panel, training bitwise equal with the watch on or off) and
the commit authority's ``--slo``.

Tolerances: none. Both packages run the same float64 host arithmetic in the
same order; records are compared exactly with their wall-clock stamps
(``ts``, ``*_unix``) left out.
"""

import asyncio
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu.config import SloConfig as JaxSloConfig
from fedrec_tpu.config import WatchConfig as JaxWatchConfig
from fedrec_tpu.obs import alerts as jalerts
from fedrec_tpu.obs import watch as jwatch
from fedrec_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fedrec_tpu.obs.tracing import Tracer as JaxTracer
from fedrec_tpu_torch.cli import obs as obs_cli
from fedrec_tpu_torch.config import ExperimentConfig, SloConfig, WatchConfig
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, set_registry, set_tracer
from fedrec_tpu_torch.obs import alerts, watch
from fedrec_tpu_torch.obs.report import build_report, load_jsonl, load_trace, render_text

ROOT = Path(__file__).resolve().parents[1]
_STAMPS = ("ts", "first_breach_unix", "fired_unix", "resolved_unix")


@pytest.fixture
def fresh_obs():
    prev_r, prev_t = set_registry(MetricsRegistry()), set_tracer(Tracer())
    yield
    set_registry(prev_r)
    set_tracer(prev_t)


def _pair():
    """(JAX, port) registry and tracer pairs, fresh."""
    return (JaxRegistry(), JaxTracer()), (MetricsRegistry(), Tracer())


def _unstamped(records):
    return [{k: v for k, v in r.items() if k not in _STAMPS} for r in records]


# ------------------------------------------------------------- SLO grammar
_SPECS = [
    "",
    "round_time:train.round_seconds:p95<2.5",
    "round_time:train.round_seconds:p95<2.5; auc_floor:eval.auc{slice=cold_user}>=0.55@0.9",
    "a:m>1e-3;b:m<=-2;c:x.y:p50>=0.5@0.999",
    "q:agg.quorum_wait_ms{worker=3,path=dcn}:p99.9<120",
    "  spaced : serve.p99_ms < 50 ",
    "nonsense",
    "x:a<1;x:b<2",
    "x:a:p0<1",
    "x:a:p101<1",
    "x:a<1@1.0",
    "x:a<1@0",
    "x:a{noequals}<1",
    "x:a<>1",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_slo_spec_equals_jax(spec):
    try:
        theirs = [vars(o) for o in jwatch.parse_slo_spec(spec)]
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            watch.parse_slo_spec(spec)
        assert str(ours.value) == str(e)
        return
    objectives = watch.parse_slo_spec(spec)
    assert [vars(o) for o in objectives] == theirs
    assert [o.describe() for o in objectives] == [
        o.describe() for o in jwatch.parse_slo_spec(spec)]


# --------------------------------------------------- burn rates and anomaly
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_rate_verdicts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(0.0, 0.6, size=200).tolist()
    for op, target, fw, sw, fb, sb in (("<", 0.9, 2, 4, 5.0, 2.5), (">=", 0.99, 12, 60, 14.4, 6.0),
                                       ("<=", 0.95, 1, 10, 3.0, 1.5)):
        spec = f"lat:m{op}1.2@{target}"
        ev = watch.BurnRateEvaluator(watch.parse_slo_spec(spec)[0], fw, sw, fb, sb)
        jev = jwatch.BurnRateEvaluator(jwatch.parse_slo_spec(spec)[0], fw, sw, fb, sb)
        ours = [ev.observe(v) for v in values]
        assert ours == [jev.observe(v) for v in values]
        assert any(v["breached"] for v in ours) or op == ">="


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anomaly_detector_equals_jax(seed):
    rng = np.random.default_rng(seed)
    series = {
        "loss": (1.0 + 0.01 * rng.standard_normal(120)).tolist(),
        "step": np.concatenate([np.full(40, 5.0), np.full(40, 9.0),
                                5.0 + rng.standard_normal(40)]).tolist(),
        "nan": [1.0, float("nan"), 1.0] * 20,
    }
    series["loss"][70] = 3.0  # one spike
    det = watch.AnomalyDetector(alpha=0.3, window=16, z=6.0, warmup=8)
    jdet = jwatch.AnomalyDetector(alpha=0.3, window=16, z=6.0, warmup=8)
    for key, vals in series.items():
        ours = [det.observe(key, v) for v in vals]
        assert ours == [jdet.observe(key, v) for v in vals]
        if key == "loss":
            assert ours[70] is not None and ours[70]["series"] == "loss"


# ------------------------------------------------------- the alert engine
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_alert_engine_transitions_equal_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    (jreg, jtr), (reg, tr) = _pair()
    reg.set_context(worker="7")
    jreg.set_context(worker="7")
    kw = dict(pending_for=2, resolve_after=3, flap_max=2, flap_window=12, history=16)
    eng = alerts.AlertEngine(registry=reg, tracer=tr, jsonl_path=tmp_path / "p.jsonl", **kw)
    jeng = jalerts.AlertEngine(registry=jreg, tracer=jtr, jsonl_path=tmp_path / "j.jsonl", **kw)
    keys = ["slo:a", "slo:b", "anomaly:x"]
    for step in range(300):
        key = keys[int(rng.integers(len(keys)))]
        breached = bool(rng.random() < (0.7 if (step // 40) % 2 else 0.2))
        kwargs = dict(severity="critical" if key.startswith("slo") else "warning",
                      summary=f"{key} at {step}", labels={"step": step % 5},
                      value=float(rng.random()), threshold=0.5,
                      pending_for=1 if key.startswith("anomaly") else None)
        a = eng.observe(key, breached, **kwargs)
        ja = jeng.observe(key, breached, **kwargs)
        assert (a is None) == (ja is None)
        if a is not None:
            assert _unstamped([a.to_dict()]) == _unstamped([ja.to_dict()])
    recs, n = eng.records_since(0)
    jrecs, jn = jeng.records_since(0)
    assert n == jn and recs and _unstamped(recs) == _unstamped(jrecs)
    assert all(r["labels"]["worker"] == "7" for r in recs)
    assert (sorted(_unstamped(eng.active()), key=lambda a: a["key"])
            == sorted(_unstamped(jeng.active()), key=lambda a: a["key"]))
    assert _unstamped(eng.history()) == _unstamped(jeng.history())
    lines = [json.loads(x) for x in (tmp_path / "p.jsonl").read_text().splitlines()]
    assert _unstamped(lines) == _unstamped(recs)
    p_snap, j_snap = reg.snapshot()["metrics"], jreg.snapshot()["metrics"]
    for name in ("alert.transitions_total", "alert.firing", "alert.flaps_suppressed_total"):
        assert p_snap[name] == j_snap[name], name


# ------------------------------------------------- the watch's metric reads
def _drive_watch(mod, reg, tr, cfg_mod, rng_seed: int, tmp_path: Path, tag: str):
    rng = np.random.default_rng(rng_seed)
    slo = cfg_mod.SloConfig(
        enabled=True, target=0.9, fast_window=2, slow_window=4, fast_burn=4.0, slow_burn=2.0,
        objectives=("rt:train.round_seconds:p90<2.0;lat:serve.p99_ms<40;"
                    "drops:agg.stale_drops_total>=0;gap:agg.gap{worker=1}<0.5;rec:val_auc>0.5"))
    w = mod.Watch(slo, cfg_mod.WatchConfig(pending_for=2, resolve_after=2, anomaly_warmup=4),
                  registry=reg, tracer=tr, jsonl_path=tmp_path / f"{tag}.jsonl")
    h = reg.histogram("train.round_seconds", buckets=(0.5, 1.0, 2.0, 4.0, 8.0))
    g = reg.gauge("serve.p99_ms")
    c = reg.counter("agg.stale_drops_total")
    lg = reg.gauge("agg.gap", labels=("worker",))
    out = []
    for tick in range(40):
        slow = (tick // 8) % 2 == 1
        for _ in range(int(rng.integers(0, 4))):
            h.observe(float(rng.uniform(2.5, 6.0) if slow else rng.uniform(0.1, 1.5)))
        g.set(float(rng.uniform(10, 80)))
        c.inc(float(rng.integers(0, 2)))
        lg.set(float(rng.random()), worker="1")
        record = {"round": tick, "val_auc": float(rng.uniform(0.4, 0.7)),
                  "training_loss": float(1.0 + 0.01 * rng.standard_normal()),
                  "flag": True}
        if tick == 13:
            w.ingest_health_trigger({"kind": "nonfinite", "round": tick, "client": 2,
                                     "round_loss": 12.5})
        if tick in (20, 21):
            w.ingest_health_outliers([{"client": 1, "update_norm": 9.0, "cohort_median": 1.0},
                                      {"client": 3, "update_norm": 4.0, "cohort_median": 1.0}])
            w.ingest_quality_outliers([{"client": 0, "auc": 0.41, "cohort_median": 0.6}])
            w.ingest_drift({"drift_rank_churn": 0.9})
        active = w.evaluate(record=record if tick % 3 else None)
        # by key: the engine orders alerts of one state by their breach
        # stamps, which two runs draw from the wall clock
        out.append(sorted(_unstamped(active), key=lambda a: a["key"]))
    recs, _ = w.engine.records_since(0)
    return out, _unstamped(recs), reg.snapshot()["metrics"]["alert.slo_burn_rate"]


@pytest.mark.parametrize("seed", [0, 1])
def test_watch_evaluate_equals_jax(seed, tmp_path):
    """Histograms as per-evaluation bucket deltas, counters as deltas,
    gauges (a labelled one too) and record keys at face value, the anomaly
    detector over the records, and the pulses: the same active sets, the
    same transition records and the same burn-rate gauges."""
    from fedrec_tpu import config as jconfig
    from fedrec_tpu_torch import config as pconfig

    (jreg, jtr), (reg, tr) = _pair()
    ours = _drive_watch(watch, reg, tr, pconfig, seed, tmp_path, "p")
    theirs = _drive_watch(jwatch, jreg, jtr, jconfig, seed, tmp_path, "j")
    assert ours == theirs
    keys = {r["key"] for r in ours[1]}
    assert {"slo:rt", "health:nonfinite", "health:outlier_clients", "quality:outlier_clients",
            "serve:drift"} <= keys


def test_bind_perf_arms_the_capture_on_firing(fresh_obs):
    class _Perf:
        watch_hook = None
        armed = 0

        def arm_capture(self):
            self.armed += 1
            return True

    w = watch.Watch(SloConfig(enabled=True), WatchConfig(anomaly=False))
    perf = _Perf()
    w.bind_perf(perf)
    perf.watch_hook(3, 10.0, 20.0)
    w.evaluate()
    assert perf.armed == 1 and w.engine.firing()[0]["key"] == watch.PERF_DROP_KEY
    w.evaluate()  # the pulse stopped: no second arming
    assert perf.armed == 1


def test_perf_monitor_routes_its_drop_through_the_hook(tmp_path, fresh_obs):
    from fedrec_tpu_torch.obs.perf import PerfMonitor

    cfg = ExperimentConfig().apply_overrides(["obs.perf.enabled=1", "obs.perf.capture_drop=0.5"])
    perf = PerfMonitor(cfg.obs.perf, cfg, 100, obs_dir=tmp_path)
    seen = []
    perf.watch_hook = lambda r, rate, mean: seen.append((r, rate, mean))
    perf._rates = [100.0, 100.0]
    assert perf.arm_capture() and perf._pending_trigger
    perf._triggered = perf.MAX_TRIGGERED_CAPTURES
    assert not perf.arm_capture()


# ------------------------------------------------------------- fleet rules
def _snap(rng, worker: int, push: int, state: dict) -> dict:
    """One worker's cumulative snapshot: round seconds, rounds, adopted
    version, quorum wait, per-peer wire counters; worker 1 slow from push
    4, worker 2 late at its pushes, worker 3's commits stall, worker 0's
    edge to "aggserver" partitioned from push 10."""
    st = state.setdefault(worker, {"sum": 0.0, "count": 0, "rounds": 0, "version": 0,
                                   "ts": 1000.0, "err": 0.0, "req": 0.0})
    round_s = float(rng.uniform(0.9, 1.1) * (6.0 if worker == 1 and push >= 4 else 1.0))
    st["sum"] += round_s
    st["count"] += 1
    st["rounds"] += 1
    if not (worker == 3 and push >= 6):
        st["version"] += 1
    st["ts"] += float(rng.uniform(0.9, 1.1) * (5.0 if worker == 2 else 1.0))
    if worker == 0 and push >= 10:
        st["err"] += 1
    else:
        st["req"] += 1
    metrics = {
        "train.round_seconds": {"kind": "histogram", "values": [
            {"labels": {}, "sum": st["sum"], "count": st["count"]}]},
        "train.rounds_total": {"kind": "counter", "values": [
            {"labels": {}, "value": float(st["rounds"])}]},
        "agg.adopted_version": {"kind": "gauge", "values": [
            {"labels": {}, "value": float(st["version"])}]},
        "wire.requests_total": {"kind": "counter", "values": [
            {"labels": {"peer": "aggserver", "op": "push"}, "value": st["req"]}]},
        "wire.errors_total": {"kind": "counter", "values": [
            {"labels": {"peer": "aggserver", "op": "push"}, "value": st["err"]}]},
    }
    if worker == 0:
        metrics["agg.quorum_wait_ms"] = {"kind": "gauge", "values": [
            {"labels": {}, "value": float(rng.uniform(90, 110) * (8 if push == 12 else 1))}]}
    return {"kind": "registry_snapshot", "ts": st["ts"], "metrics": metrics}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_rules_transitions_equal_jax(seed, tmp_path):
    (jreg, jtr), (reg, tr) = _pair()
    wcfg = dict(fleet_straggler_factor=2.0, fleet_straggler_evals=2, fleet_stalled_pushes=2,
                fleet_quorum_factor=3.0, resolve_after=2)
    rules = watch.FleetRules(WatchConfig(**wcfg), target_world=4, registry=reg, tracer=tr,
                             jsonl_path=tmp_path / "p.jsonl")
    jrules = jwatch.FleetRules(JaxWatchConfig(**wcfg), target_world=4, registry=jreg,
                               tracer=jtr, jsonl_path=tmp_path / "j.jsonl")
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    state, jstate = {}, {}
    for push in range(16):
        for w in range(4):
            rules.observe_push(str(w), _snap(rng, w, push, state))
            jrules.observe_push(str(w), _snap(jrng, w, push, jstate))
        world = 4 if push < 8 or push > 12 else 3
        rules.observe_world(world)
        jrules.observe_world(world)
        assert (sorted(_unstamped(rules.engine.active()), key=lambda a: a["key"])
                == sorted(_unstamped(jrules.engine.active()), key=lambda a: a["key"]))
    recs = _unstamped(rules.engine.records_since(0)[0])
    assert recs == _unstamped(jrules.engine.records_since(0)[0])
    fired = {r["key"] for r in recs if r["event"] == "firing"}
    assert {"fleet:straggler:1", "fleet:straggler:2", "fleet:stalled_commit:3",
            "fleet:partition:0->aggserver", "fleet:world_below_target",
            "fleet:quorum_wait_growth"} <= fired
    assert not {"fleet:straggler:0", "fleet:straggler:3"} & fired


def test_alert_record_readers_equal_jax():
    rng = np.random.default_rng(5)
    records = [{"kind": "metrics", "ts": 0.5}]
    for i in range(40):
        records.append({"kind": "alert", "key": f"k{int(rng.integers(5))}",
                        "event": "firing" if rng.random() < 0.6 else "resolved",
                        "ts": float(rng.random() * 100)})
    assert watch.alert_records(records) == jwatch.alert_records(records)
    assert watch.active_alerts(records) == jwatch.active_alerts(records)


# --------------------------------------------------------- port surfaces
def test_serving_alerts_admin_reads_the_watch(fresh_obs):
    """A server with an unmeetable SLO over ``serve.p99_ms`` answers
    ``{"cmd": "alerts"}`` with the firing alert once the heartbeat has
    evaluated it twice (``pending_for`` 2)."""
    from fedrec_tpu_torch.cli import serve
    from fedrec_tpu_torch.serving import serve_forever

    args = serve.build_parser().parse_args(
        ["--synthetic", "64", "--device", "cpu", "--set", "model.news_dim=32",
         "--set", "model.num_heads=4", "--set", "model.head_dim=8", "--set",
         "model.query_dim=16"])
    cfg = ExperimentConfig().apply_overrides(args.overrides)
    svc = serve.build_service(args, cfg)
    svc.watch = watch.Watch(SloConfig(enabled=True, objectives="p99:serve.p99_ms<0"),
                            WatchConfig(), registry=svc.registry)

    async def drive():
        task = asyncio.ensure_future(serve_forever(svc, port=0, metrics_every_s=0.05))
        await asyncio.sleep(0.2)
        await svc.handle({"id": 1, "history": [1, 2]})
        for _ in range(600):
            await asyncio.sleep(0.05)
            reply = await svc.handle({"cmd": "alerts"})
            if any(a["state"] == "firing" for a in reply["alerts"]["active"]):
                break
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return reply

    reply = asyncio.run(asyncio.wait_for(drive(), 60))
    (alert,) = reply["alerts"]["active"]
    assert alert["key"] == "slo:p99" and alert["state"] == "firing"


_SMALL = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
          "model.bert_hidden=48", "data.max_his_len=8", "data.max_title_len=6",
          "data.batch_size=8", "model.text_encoder_mode=head", "train.snapshot_dir="]


def _trainer_run(obs_dir: Path, *over: str):
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.train import Trainer

    cfg = ExperimentConfig().apply_overrides([
        *_SMALL, "fed.num_clients=2", "fed.rounds=3", f"obs.dir={obs_dir}", *over])
    data = make_synthetic_mind(num_news=100, num_train=64, num_valid=40, title_len=6,
                               his_len_range=(1, 8), seed=1)
    toks = np.random.default_rng(0).standard_normal((100, 6, 48)).astype(np.float32)
    prev_r, prev_t = set_registry(MetricsRegistry()), set_tracer(Tracer())
    try:
        trainer = Trainer(cfg, data, toks, device="cpu")
        history = trainer.run()
        params = [p.detach().clone() for s in trainer.states for p in s.model.parameters()]
    finally:
        set_registry(prev_r)
        set_tracer(prev_t)
    return history, params


def test_trainer_watch_fires_and_trains_bitwise_as_without(tmp_path, capsys):
    on, off = tmp_path / "on", tmp_path / "off"
    h_on, p_on = _trainer_run(on, "obs.slo.enabled=1",
                              "obs.slo.objectives=round_time:train.round_seconds:p50<0.0001")
    h_off, p_off = _trainer_run(off)
    assert [(r.train_loss, r.val_metrics) for r in h_on] == [
        (r.train_loss, r.val_metrics) for r in h_off]
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))
    records, snaps = load_jsonl(on / "metrics.jsonl")
    fired = [r for r in records if r.get("kind") == "alert"]
    assert fired and fired[0]["key"] == "slo:round_time" and fired[0]["event"] == "firing"
    assert not [r for r in load_jsonl(off / "metrics.jsonl")[0] if r.get("kind") == "alert"]
    capsys.readouterr()
    assert obs_cli.main(["alerts", str(on)]) == 1
    assert "slo:round_time" in capsys.readouterr().out
    assert obs_cli.main(["tail", str(on), "--once"]) == 1
    assert obs_cli.main(["alerts", str(off)]) == 0
    assert obs_cli.main(["tail", str(off), "--once"]) == 0
    text = render_text(build_report(records, snaps, load_trace(on / "trace.json")))
    assert "## Alerts" in text and "STILL FIRING" in text
    assert obs_cli.main(["alerts", str(tmp_path / "nowhere")]) == 2


def test_authority_slo_writes_a_firing_alert(tmp_path):
    """``python -m fedrec_tpu_torch.agg.server --slo`` over the authority's
    own ``agg.incarnation`` gauge (unmeetable: > 5 at the first start)
    writes a firing record into its ``--obs-dir`` at its second 2 s tick."""
    from fedrec_tpu_torch.parallel.membership import free_port

    port, obs = free_port(), tmp_path / "worker_aggserver"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedrec_tpu_torch.agg.server", f"127.0.0.1:{port}",
         "--obs-dir", str(obs), "--slo", "inc:agg.incarnation>5"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        fired = []
        while time.time() < deadline and not fired:
            time.sleep(0.5)
            if (obs / "metrics.jsonl").exists():
                fired = [r for r in load_jsonl(obs / "metrics.jsonl")[0]
                         if r.get("kind") == "alert"]
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
    assert fired and fired[0]["key"] == "slo:inc", out
    assert fired[0]["labels"]["worker"] == "aggserver"
    assert "cuda initialised: False" in out
