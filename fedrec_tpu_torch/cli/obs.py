"""``fedrec-obs`` for the port: render, merge and replay the observability
artifacts of a run or a fleet, the port of ``fedrec_tpu/cli/obs.py``.

Reads the artifacts ``Trainer`` writes under ``obs.dir`` (and ``cli.serve
--obs-dir``): ``metrics.jsonl`` (records and registry snapshots, with
``metrics.jsonl.1`` when rotated), ``trace.json`` (Chrome-trace host
spans), ``prometheus.txt``, and the flight recorder's ``flightrec/`` dump.

  python -m fedrec_tpu_torch.cli.obs report <dir | metrics.jsonl> [--trace T] [--json]
      the one-page run report.
  python -m fedrec_tpu_torch.cli.obs prom <dir | metrics.jsonl>
      the last registry snapshot as a Prometheus exposition.
  python -m fedrec_tpu_torch.cli.obs quality <dir | metrics.jsonl> [--json]
      per-slice eval metrics, calibration, per-client AUC, serving drift
      (exit 2 without obs.quality telemetry).
  python -m fedrec_tpu_torch.cli.obs perf <dir | metrics.jsonl> [--json]
      throughput, MFU trend, roofline verdicts, the phase table, device
      bytes by component, captured traces (exit 2 without obs.perf
      telemetry).
  python -m fedrec_tpu_torch.cli.obs replay <dir | flightrec dir> [--max-steps N]
      [--device cuda|cpu] [--json]
      re-run the flight recorder's dumped steps from the dumped round-entry
      state; exit 0 when the dump's non-finite trigger is reproduced, 1
      when not. Runs on ``cuda`` unless given ``--device cpu`` (the JAX
      verb runs on the CPU).

  python -m fedrec_tpu_torch.cli.obs fleet <dir> [--json]
      the fleet report over ``worker_*`` dirs (a shared obs root, a
      collector's ``--dir``, or one worker's obs dir): per-worker identity,
      the membership timeline, per-round critical path, DCN bytes, the
      Aggregation, Wire and Alerts panels.
  python -m fedrec_tpu_torch.cli.obs fleet-trace <dir> [-o merged.json]
      every worker's spans in one clock-aligned Perfetto trace, a track a
      worker, with the wire's flow arrows.
  python -m fedrec_tpu_torch.cli.obs alerts <dir | metrics.jsonl> [--json]
      the alert timeline and the still-firing set; exit 1 while any alert is
      still firing at the end of the log(s), 0 when quiet, 2 on an error.
  python -m fedrec_tpu_torch.cli.obs tail <dir | metrics.jsonl> [--once] [--interval S]
      follow the event log(s), printing each alert transition as it lands;
      ``--once`` prints what is recorded and exits as ``alerts`` does.

Every verb reads artifacts of either package; all but ``replay`` import no
torch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from fedrec_tpu_torch.obs.registry import snapshot_to_prometheus
from fedrec_tpu_torch.obs.report import (
    build_report,
    load_jsonl,
    load_trace,
    render_text,
)


def _fail(msg: str) -> int:
    print(f"fedrec-obs: {msg}", file=sys.stderr)
    return 2


def _resolve(path_arg: str) -> tuple[Path, Path | None]:
    """A directory (the obs.dir layout) or an explicit metrics.jsonl path
    -> (metrics_path, trace_path_or_None)."""
    p = Path(path_arg)
    if p.is_dir():
        metrics = p / "metrics.jsonl"
        trace = p / "trace.json"
        return metrics, (trace if trace.exists() else None)
    return p, None


def _load_event_log(metrics_path: Path):
    """load_jsonl with operator-grade failure messages instead of
    tracebacks; returns (records, snapshots) or an int exit code."""
    if not metrics_path.exists() and not Path(str(metrics_path) + ".1").exists():
        parent = metrics_path.parent
        hint = (
            " (the directory does not exist — check the obs dir path)"
            if not parent.exists()
            else " (directory exists but holds no event log — was the run "
                 "started with obs.dir / --obs-dir?)"
        )
        return _fail(f"no event log at {metrics_path}{hint}")
    try:
        return load_jsonl(metrics_path)
    except OSError as e:
        return _fail(f"cannot read {metrics_path}: {e}")


def _cmd_report(args) -> int:
    metrics_path, trace_path = _resolve(args.path)
    if args.trace:
        trace_path = Path(args.trace)
        if not trace_path.exists():
            return _fail(f"no trace file at {trace_path}")
    loaded = _load_event_log(metrics_path)
    if isinstance(loaded, int):
        return loaded
    records, snapshots = loaded
    trace_events = None
    if trace_path:
        try:
            trace_events = load_trace(trace_path)
        except (OSError, json.JSONDecodeError, KeyError) as e:
            print(f"fedrec-obs: skipping unreadable trace {trace_path}: {e}",
                  file=sys.stderr)
    report = build_report(records, snapshots, trace_events)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_text(report))
    return 0


def _cmd_prom(args) -> int:
    metrics_path, _ = _resolve(args.path)
    loaded = _load_event_log(metrics_path)
    if isinstance(loaded, int):
        return loaded
    _, snapshots = loaded
    if not snapshots:
        return _fail(
            f"no registry snapshot in {metrics_path} (the run may have "
            "died before its first obs.snapshot_every round)"
        )
    # the SAME renderer the live {"cmd": "prometheus"} endpoint uses —
    # offline output cannot drift from the wire exposition
    print(snapshot_to_prometheus(snapshots[-1]), end="")
    return 0


# ----------------------------------------------------------------- quality
def _cmd_quality(args) -> int:
    from fedrec_tpu_torch.obs.report import quality_detail_from_snapshot

    metrics_path, _ = _resolve(args.path)
    loaded = _load_event_log(metrics_path)
    if isinstance(loaded, int):
        return loaded
    _, snapshots = loaded
    if not snapshots:
        return _fail(
            f"no registry snapshot in {metrics_path} (the run may have "
            "died before its first obs.snapshot_every round)"
        )
    detail = quality_detail_from_snapshot(snapshots[-1])
    if not detail:
        return _fail(
            f"no quality telemetry in {metrics_path} — was the run "
            "started with obs.quality.enabled=1 (sliced eval; on "
            "fedrec-serve it also arms the drift probe, "
            "obs.quality.probe_users)?"
        )
    if args.json:
        print(json.dumps(detail, indent=2))
        return 0
    lines = ["# fedrec_tpu_torch quality report", ""]
    slices = detail.get("slices")
    if slices:
        lines.append("## Eval slices (last eval, ascending AUC)")
        lines.append(
            f"{'slice':<20} {'auc':>8} {'mrr':>8} {'ndcg5':>8} "
            f"{'ndcg10':>8} {'count':>7}"
        )
        ordered = sorted(
            slices.items(), key=lambda kv: kv[1].get("auc", float("inf"))
        )
        for name, m in ordered:
            lines.append(
                f"{name:<20} {m.get('auc', float('nan')):>8.4f} "
                f"{m.get('mrr', float('nan')):>8.4f} "
                f"{m.get('ndcg5', float('nan')):>8.4f} "
                f"{m.get('ndcg10', float('nan')):>8.4f} "
                f"{int(m.get('count', 0)):>7}"
            )
        if detail.get("slices_skipped"):
            lines.append(
                f"(+ {int(detail['slices_skipped'])} slice evaluations "
                "skipped: empty/degenerate strata)"
            )
        lines.append("")
    if "ece" in detail or "score_separation" in detail:
        lines.append("## Scores & calibration")
        if "score_separation" in detail:
            dp = (
                f", d'={detail['score_dprime']:.3f}"
                if "score_dprime" in detail else ""
            )
            lines.append(
                f"separation: {detail['score_separation']:.4f}{dp}"
            )
        if "ece" in detail:
            lines.append(f"ece: {detail['ece']:.4f}")
        for row in detail.get("calibration", []):
            if row.get("count"):
                lines.append(
                    f"  bin {row['bin']}: conf="
                    f"{row.get('confidence', float('nan')):.3f} "
                    f"acc={row.get('accuracy', float('nan')):.3f} "
                    f"n={int(row['count'])}"
                )
        lines.append("")
    if "client_auc" in detail:
        lines.append("## Per-client AUC")
        lines.append(", ".join(
            f"c{c}={v:.4f}" for c, v in detail["client_auc"].items()
        ))
        if detail.get("quality_outlier_client_evals"):
            lines.append(
                "quality-outlier client-evals: "
                f"{int(detail['quality_outlier_client_evals'])}"
            )
        lines.append("")
    drift = detail.get("drift")
    if drift:
        lines.append("## Serving drift (last pre-swap probe)")
        if "score_shift_mean" in drift:
            lines.append(
                f"|Δscore| mean={drift['score_shift_mean']:.4g} "
                f"max={drift.get('score_shift_max', 0):.4g}"
            )
        if "topk_jaccard" in drift:
            lines.append(
                f"top-k jaccard={drift['topk_jaccard']:.3f} "
                f"(churn {drift.get('rank_churn', 0):.3f}) over "
                f"{int(drift.get('checks', 0))} check(s)"
            )
        lines.append("")
    print("\n".join(lines))
    return 0


# -------------------------------------------------------------------- perf
def _cmd_perf(args) -> int:
    from fedrec_tpu_torch.obs.report import perf_detail_from_snapshot

    metrics_path, trace_path = _resolve(args.path)
    loaded = _load_event_log(metrics_path)
    if isinstance(loaded, int):
        return loaded
    records, snapshots = loaded
    if not snapshots:
        return _fail(
            f"no registry snapshot in {metrics_path} (the run may have "
            "died before its first obs.snapshot_every round)"
        )
    detail = perf_detail_from_snapshot(snapshots[-1])
    if not detail:
        return _fail(
            f"no perf telemetry in {metrics_path} — was the run started "
            "with obs.perf.enabled=1 (live MFU/roofline gauges, device-memory "
            "attribution)?"
        )
    # the MFU/verdict trend rides the per-round MetricLogger records
    trend = [
        (r.get("round"), r.get("perf.mfu"), r.get("perf.samples_per_sec"),
         r.get("perf.verdict"))
        for r in records
        if "perf.samples_per_sec" in r and "round" in r
    ]
    captures = [
        r for r in records
        if r.get("kind") in ("perf_capture", "profile_trace")
    ]
    phases = None
    if trace_path:
        try:
            from fedrec_tpu_torch.obs.fleet import ROUND_PHASES
            from fedrec_tpu_torch.obs.report import span_summary

            # the same rollup build_report's span table uses, filtered to
            # the round phases — the two views cannot drift on one trace
            phases = span_summary(load_trace(trace_path), names=ROUND_PHASES)
        except (OSError, json.JSONDecodeError, KeyError) as e:
            print(f"fedrec-obs: skipping unreadable trace {trace_path}: {e}",
                  file=sys.stderr)
            phases = None
    if args.json:
        doc = dict(detail)
        if trend:
            doc["trend"] = [
                {"round": r, "mfu": m, "samples_per_sec": s, "verdict": v}
                for r, m, s, v in trend
            ]
        if captures:
            # NOT "captures": perf_detail_from_snapshot already uses that
            # key for the numeric counter — a consumer must never see the
            # key's type flip between runs
            doc["capture_records"] = captures
        if phases:
            doc["phases"] = phases
        print(json.dumps(doc, indent=2))
        return 0
    lines = ["# fedrec_tpu_torch perf report", ""]
    head = []
    if "samples_per_sec" in detail:
        head.append(f"throughput: {detail['samples_per_sec']:.1f} samples/s")
    if "mfu" in detail:
        head.append(f"mfu: {detail['mfu']:.4f}")
    if "hbm_fraction" in detail:
        head.append(f"hbm: {detail['hbm_fraction']:.3f} of peak")
    if head:
        lines.append(", ".join(head) + " (last round)")
    if "verdict_rounds" in detail:
        from fedrec_tpu_torch.obs.perf import ROOFLINE_VERDICTS

        lines.append("")
        lines.append("## Roofline verdicts")
        for key, n in sorted(detail["verdict_rounds"].items()):
            lines.append(
                f"  {int(n):>4} round(s)  {ROOFLINE_VERDICTS.get(key, key)}"
            )
    if phases:
        lines.append("")
        lines.append("## Phase table (host spans)")
        lines.append(f"{'phase':<14} {'count':>7} {'total_ms':>10} {'mean_ms':>9}")
        for name, p in phases.items():
            lines.append(
                f"{name:<14} {p['count']:>7} {p['total_ms']:>10.1f} "
                f"{p['mean_ms']:>9.2f}"
            )
    if trend:
        lines.append("")
        lines.append("## Trend (last 8 rounds)")
        for r, m, s, v in trend[-8:]:
            mfu_s = f" mfu={m:.4f}" if m is not None else ""
            lines.append(
                f"  r{int(r)}: {s:.1f} samples/s{mfu_s}"
                + (f" [{v}]" if v else "")
            )
    if "hbm_components" in detail:
        lines.append("")
        lines.append("## HBM by component (descending)")
        for name, v in sorted(
            detail["hbm_components"].items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"  {name:<12} {v / (1024 * 1024):>10.1f} MB")
    if "compile_cost" in detail:
        lines.append("")
        lines.append("## Compile cost (xla cost_analysis)")
        lines.append(
            f"{'fn':<20} {'gflops':>10} {'MB_accessed':>12} {'intensity':>10}"
        )
        for fn, c in detail["compile_cost"].items():
            gf = c.get("flops")
            mb = c.get("bytes_accessed")
            ai = c.get("arithmetic_intensity")
            lines.append(
                f"{fn:<20} "
                f"{(gf / 1e9 if gf is not None else float('nan')):>10.2f} "
                f"{(mb / 1e6 if mb is not None else float('nan')):>12.2f} "
                f"{(ai if ai is not None else float('nan')):>10.1f}"
            )
    if captures:
        lines.append("")
        lines.append("## Captured traces")
        for c in captures:
            tag = c.get("kind")
            rnd = c.get("round")
            lines.append(
                f"  {tag}" + (f" r{int(rnd)}" if rnd is not None else "")
                + f": {c.get('logdir')}"
            )
    print("\n".join(lines))
    return 0


# ------------------------------------------------------------------ replay
def _resolve_flightrec(path_arg: str) -> Path | None:
    """obs dir / flightrec dir / manifest.json path -> flightrec dir."""
    p = Path(path_arg)
    if p.name == "manifest.json":
        p = p.parent
    if (p / "manifest.json").exists():
        return p
    if (p / "flightrec" / "manifest.json").exists():
        return p / "flightrec"
    return None


def _cmd_replay(args) -> int:
    flight_dir = _resolve_flightrec(args.path)
    if flight_dir is None:
        return _fail(
            f"no flight-recorder dump under {args.path} — expected "
            "<obs.dir>/flightrec/manifest.json (dumps are written when the "
            "health sentry trips with obs.dir set and "
            "obs.health.flight_recorder on)"
        )
    try:
        manifest = json.loads((flight_dir / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        return _fail(f"unreadable manifest at {flight_dir}/manifest.json: {e}")
    if manifest.get("kind") != "flight_recorder_dump":
        return _fail(f"{flight_dir}/manifest.json is not a flight-recorder dump")
    if not manifest.get("records"):
        return _fail(
            "the dump holds no batch records (the trigger fired before any "
            "step was recorded); nothing to replay"
        )
    if manifest.get("state_file") is None:
        return _fail("the dump holds no state checkpoint; cannot replay")
    if manifest.get("state_file") != "state.pt":
        return _fail(
            f"the dump's state is {manifest['state_file']!r}, the JAX package's "
            "format: replay it with the JAX package's fedrec-obs"
        )
    if manifest.get("table_file") is None:
        return _fail(
            "the dump omitted the feature table "
            f"(skipped at {manifest.get('table_skipped_mb', '?')} MB — raise "
            "obs.health.dump_table_max_mb); cannot replay"
        )

    import numpy as np
    import torch

    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.device import resolve_device, torch_dtype
    from fedrec_tpu_torch.fed.strategies import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train.checkpoint import load_host_states
    from fedrec_tpu_torch.train.state import init_client_state, replicate_state
    from fedrec_tpu_torch.train.step import build_fed_train_step, build_param_sync

    dev = resolve_device(args.device)
    cfg = ExperimentConfig.from_dict(manifest["config"])
    # replay is per-batch and file-free; the sentinel is its verdict
    cfg.data.prefetch_batches = 0
    cfg.obs.dir = ""
    cfg.obs.health.sentry = True
    mode = manifest.get("mode") or None
    model = init_params(NewsRecommender(cfg.model), seed=0).to(dev)
    states = replicate_state(init_client_state(model, cfg, 0), cfg.fed.num_clients, 1)
    try:
        snap = torch.load(flight_dir / manifest["state_file"], map_location="cpu",
                          weights_only=True)
        load_host_states(states, snap)
    except (OSError, ValueError, RuntimeError) as e:
        return _fail(f"cannot restore the dumped state: {e}")
    table = torch.from_numpy(np.load(flight_dir / manifest["table_file"])).to(dev)
    if table.is_floating_point():
        table = table.to(torch_dtype(cfg.model.dtype))
    strategy = get_strategy(cfg.fed.strategy)
    step = build_fed_train_step(model, cfg, strategy, mode=mode, device=dev)
    sync = build_param_sync(cfg, strategy) if strategy.sync_params_every_round else None
    weights = {int(k): np.asarray(v) for k, v in manifest.get("weights", {}).items()}

    records = sorted(manifest["records"], key=lambda r: (r["round"], r["step"]))
    trigger = manifest.get("trigger", {})
    max_steps = args.max_steps or len(records)
    out_rows: list[dict] = []
    first_bad: dict | None = None
    prev_round = records[0]["round"]
    for rec in records[:max_steps]:
        if rec["round"] != prev_round:
            if sync is not None and prev_round in weights:
                # the recorded round-end sync, so a dump spanning rounds
                # replays the same trajectory
                states = sync(states, np.asarray(weights[prev_round]))
            prev_round = rec["round"]
        try:
            batch = dict(np.load(flight_dir / rec["file"]))
        except OSError as e:
            return _fail(f"cannot read batch record {rec['file']}: {e}")
        states, metrics = step(states, batch, table)
        host = {k: np.asarray(torch.as_tensor(v).detach().float().cpu())
                for k, v in metrics.items() if k.startswith("health.") or k == "mean_loss"}
        row = {
            "round": rec["round"],
            "step": rec["step"],
            "loss": float(host["mean_loss"].reshape(-1)[0]),
            "grad_norm_max": float(np.max(host["health.grad_norm"])),
            "update_norm_max": float(np.max(host["health.update_norm"])),
            "param_norm_max": float(np.max(host["health.param_norm"])),
            "nonfinite": int(host["health.nonfinite"].sum()),
        }
        out_rows.append(row)
        if not args.json:
            print(
                f"round {row['round']} step {row['step']}: "
                f"loss={row['loss']:.6g} grad={row['grad_norm_max']:.4g} "
                f"update={row['update_norm_max']:.4g} "
                f"param={row['param_norm_max']:.4g} "
                f"nonfinite={row['nonfinite']}"
            )
        if row["nonfinite"] > 0:
            first_bad = row
            break

    reproduced = first_bad is not None
    verdict = {
        "trigger": trigger,
        "device": str(dev),
        "steps_replayed": len(out_rows),
        "reproduced_nonfinite": reproduced,
        "first_nonfinite": first_bad,
        "rows": out_rows,
    }
    if args.json:
        print(json.dumps(verdict, indent=2))
    elif reproduced:
        print(
            f"REPRODUCED: non-finite step at round {first_bad['round']} "
            f"step {first_bad['step']} (trigger was "
            f"{trigger.get('kind')} at round {trigger.get('round')} "
            f"step {trigger.get('step')})"
        )
    elif trigger.get("kind") == "nonfinite":
        print(
            "NOT REPRODUCED: no replayed step went non-finite — the ring may "
            "have dropped the poisoning step (ring_complete="
            f"{manifest.get('ring_complete')})"
        )
    else:
        print(
            f"no non-finite step (trigger was {trigger.get('kind')!r}); "
            "the norm trajectory above is the evidence"
        )
    if trigger.get("kind") == "nonfinite":
        return 0 if reproduced else 1
    return 0


# ------------------------------------------------------------------- fleet
def _load_fleet(path_arg: str):
    from fedrec_tpu_torch.obs.fleet import load_fleet_dir

    try:
        return load_fleet_dir(path_arg)
    except FileNotFoundError as e:
        return _fail(str(e))


def _cmd_fleet(args) -> int:
    from fedrec_tpu_torch.obs.fleet import build_fleet_report, render_fleet_text

    workers = _load_fleet(args.path)
    if isinstance(workers, int):
        return workers
    report = build_fleet_report(workers)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_fleet_text(report))
    return 0


def _cmd_fleet_trace(args) -> int:
    from fedrec_tpu_torch.obs.fleet import build_fleet_trace

    workers = _load_fleet(args.path)
    if isinstance(workers, int):
        return workers
    doc = build_fleet_trace(workers)
    out = Path(args.out) if args.out else Path(args.path) / "fleet_trace.json"
    try:
        with open(out, "w") as f:
            json.dump(doc, f)
    except OSError as e:
        return _fail(f"cannot write merged trace to {out}: {e}")
    n_ev = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    print(
        f"merged {n_ev} events from {len(doc['otherData']['workers'])} "
        f"worker track(s) -> {out} (load in https://ui.perfetto.dev)"
    )
    return 0


# ------------------------------------------------------------------ alerts
def _alert_sources(path_arg: str) -> list[tuple[str | None, Path]]:
    """-> [(worker_or_None, metrics_path)]: every ``worker_*`` log under
    a shared/collector dir, or the single obs-dir / file log."""
    p = Path(path_arg)
    if p.is_dir():
        wdirs = sorted(d for d in p.glob("worker_*") if d.is_dir())
        if wdirs:
            return [
                (d.name[len("worker_"):], d / "metrics.jsonl")
                for d in wdirs
            ]
        return [(None, p / "metrics.jsonl")]
    return [(None, p)]


def _load_alert_logs(path_arg: str):
    """-> (timeline, active) across every source log, or an int exit
    code.  Alert keys are scoped per source so two workers' ``slo:x``
    lifecycles never collapse into one."""
    from fedrec_tpu_torch.obs.watch import active_alerts, alert_records

    sources = _alert_sources(path_arg)
    timeline: list[dict] = []
    active: list[dict] = []
    found_log = False
    for worker, mp in sources:
        if not mp.exists() and not Path(str(mp) + ".1").exists():
            continue
        try:
            records, _ = load_jsonl(mp)
        except OSError as e:
            return _fail(f"cannot read {mp}: {e}")
        found_log = True
        recs = alert_records(records)
        if worker is not None:
            for r in recs:
                r.setdefault("labels", {}).setdefault("worker", worker)
        timeline.extend(recs)
        active.extend(active_alerts(recs))
    if not found_log:
        return _fail(
            f"no event log under {path_arg} (was the run started with "
            "obs.dir / --obs-dir, and obs.slo.enabled to record alerts?)"
        )
    timeline.sort(key=lambda r: r.get("ts", 0.0))
    return timeline, active


def _format_alert_line(rec: dict) -> str:
    import time as _time

    ts = _time.strftime("%H:%M:%S", _time.localtime(rec.get("ts", 0.0)))
    worker = (rec.get("labels") or {}).get("worker")
    wtxt = f" worker={worker}" if worker is not None else ""
    return (
        f"{ts} {rec.get('event', '?').upper():<8} "
        f"{rec.get('severity', '?'):<8} {rec.get('key', '?')}{wtxt}"
        f"  {rec.get('summary', '')}"
    )


def _cmd_alerts(args) -> int:
    loaded = _load_alert_logs(args.path)
    if isinstance(loaded, int):
        return loaded
    timeline, active = loaded
    if args.json:
        print(json.dumps({"timeline": timeline, "active": active}, indent=2))
        return 1 if active else 0
    print("# Alert timeline")
    if timeline:
        for rec in timeline:
            print(_format_alert_line(rec))
    else:
        print("(no alert transitions recorded)")
    print()
    print("# Active alerts")
    if active:
        for rec in sorted(active, key=lambda r: r.get("ts", 0.0)):
            print(_format_alert_line(rec))
    else:
        print("(none — everything resolved)")
    # the scriptable contract: firing -> 1, quiet -> 0 (errors exit 2)
    return 1 if active else 0


def _cmd_tail(args) -> int:
    import time as _time

    if args.once:
        loaded = _load_alert_logs(args.path)
        if isinstance(loaded, int):
            return loaded
        timeline, active = loaded
        for rec in timeline:
            print(_format_alert_line(rec))
        return 1 if active else 0
    sources = _alert_sources(args.path)
    offsets: dict[Path, int] = {}
    print(
        f"fedrec-obs: following {len(sources)} log(s) under {args.path} "
        "(ctrl-c to stop)",
        file=sys.stderr,
    )
    try:
        while True:
            for worker, mp in sources:
                try:
                    size = mp.stat().st_size
                except OSError:
                    continue
                pos = offsets.get(mp, 0)
                if size < pos:
                    pos = 0  # the log rotated under us: re-read from top
                if size == pos:
                    continue
                try:
                    with open(mp, "rb") as f:
                        f.seek(pos)
                        chunk = f.read()
                except OSError:
                    continue
                # consume only COMPLETE lines; a partially-flushed tail
                # stays unread until the writer finishes it
                nl = chunk.rfind(b"\n")
                if nl < 0:
                    continue
                offsets[mp] = pos + nl + 1
                for line in chunk[: nl + 1].splitlines():
                    try:
                        rec = json.loads(line)
                    except (json.JSONDecodeError, UnicodeDecodeError):
                        continue
                    if rec.get("kind") != "alert":
                        continue
                    if worker is not None:
                        rec.setdefault("labels", {}).setdefault(
                            "worker", worker
                        )
                    print(_format_alert_line(rec), flush=True)
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fedrec-obs", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render the one-page run report")
    rep.add_argument("path", help="obs dir or metrics.jsonl path")
    rep.add_argument("--trace", default=None, help="explicit trace.json path")
    rep.add_argument("--json", action="store_true",
                     help="machine-readable report instead of text")
    rep.set_defaults(fn=_cmd_report)
    prom = sub.add_parser("prom", help="Prometheus exposition from the last registry snapshot")
    prom.add_argument("path", help="obs dir or metrics.jsonl path")
    prom.set_defaults(fn=_cmd_prom)
    qu = sub.add_parser("quality", help="model-quality report (obs.quality telemetry)")
    qu.add_argument("path", help="obs dir or metrics.jsonl path")
    qu.add_argument("--json", action="store_true", help="machine-readable detail")
    qu.set_defaults(fn=_cmd_quality)
    pf = sub.add_parser("perf", help="performance report (obs.perf telemetry)")
    pf.add_argument("path", help="obs dir or metrics.jsonl path")
    pf.add_argument("--json", action="store_true", help="machine-readable detail")
    pf.set_defaults(fn=_cmd_perf)
    rp = sub.add_parser("replay", help="re-run a flight-recorder dump to confirm/bisect")
    rp.add_argument("path", help="obs dir, flightrec dir, or manifest.json")
    rp.add_argument("--max-steps", type=int, default=0,
                    help="replay at most N recorded steps (0 = all)")
    rp.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a GPU unless 'cpu')")
    rp.add_argument("--json", action="store_true", help="machine-readable verdict")
    rp.set_defaults(fn=_cmd_replay)
    fl = sub.add_parser("fleet", help="fleet report over worker_* obs dirs (critical path, "
                                      "membership, DCN bytes, aggregation, wire, alerts)")
    fl.add_argument("path", help="shared obs dir / collector dir / one worker's obs dir")
    fl.add_argument("--json", action="store_true", help="machine-readable report")
    fl.set_defaults(fn=_cmd_fleet)
    ft = sub.add_parser("fleet-trace", help="every worker's spans in one clock-aligned "
                                            "Perfetto trace with per-worker tracks")
    ft.add_argument("path", help="shared obs dir / collector dir / one worker's obs dir")
    ft.add_argument("-o", "--out", default=None,
                    help="output path (default <dir>/fleet_trace.json)")
    ft.set_defaults(fn=_cmd_fleet_trace)
    al = sub.add_parser("alerts", help="alert timeline and active set; exit 1 while any "
                                       "alert is still firing")
    al.add_argument("path", help="obs dir, collector/shared dir, or metrics.jsonl path")
    al.add_argument("--json", action="store_true",
                    help="machine-readable {timeline, active} (same exit codes)")
    al.set_defaults(fn=_cmd_alerts)
    tl = sub.add_parser("tail", help="follow the event log(s), printing alert transitions")
    tl.add_argument("path", help="obs dir, collector/shared dir, or metrics.jsonl path")
    tl.add_argument("--once", action="store_true",
                    help="print the recorded transitions and exit as alerts does")
    tl.add_argument("--interval", type=float, default=1.0,
                    help="poll interval seconds (default 1.0)")
    tl.set_defaults(fn=_cmd_tail)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
