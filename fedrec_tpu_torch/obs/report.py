"""Run-report renderer: JSONL event log + registry snapshots + trace -> one
page. A copy of ``fedrec_tpu/obs/report.py`` (the port imports nothing of
the JAX package), so either package's ``fedrec-obs`` reads either's
artifacts.

The artifact contract (written by ``Trainer`` under ``obs.dir`` and by
``cli.serve --obs-dir``):

* ``metrics.jsonl``: interleaved JSON lines of two kinds: metric-log
  records (``{"step": .., "elapsed_sec": .., "training_loss": .., ...}``)
  and registry snapshots (``{"kind": "registry_snapshot", "ts": ..,
  "metrics": {...}}``, one per round and one at shutdown);
* ``trace.json``: Chrome-trace/Perfetto host spans (``obs.tracing``);
* ``prometheus.txt``: the final text exposition.

``build_report`` digests those into one dict (round throughput, loss
trajectory, serve p50/p99, prefetch stalls, epsilon trajectory, health,
cap-overflow counts, span summary) and ``render_text`` prints it; the
``fedrec-obs`` CLI is a thin wrapper over these two calls. The Alerts panel
reads the watch layer's ``{"kind": "alert"}`` records (``obs.watch``). The
port's kernel builds (``kernel.builds_total``, ``obs.device.BuildWatch``)
are its own ``kernels`` section.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any


def rotate_jsonl(path, max_mb: float) -> bool:
    """Size-based rotation for a JSONL event log: when ``path`` exceeds
    ``max_mb`` MB it is renamed to ``<path>.1`` (replacing any previous
    rotation — one level kept, so the log is bounded at ~2×max_mb) and the
    next append starts a fresh file.  ``max_mb <= 0`` disables.  Returns
    True when a rotation happened.  Writers call this BEFORE appending;
    :func:`load_jsonl` reads the rotated file first, so record order is
    preserved across the boundary."""
    if not max_mb or max_mb <= 0:
        return False
    p = Path(path)
    try:
        if p.stat().st_size < max_mb * 1e6:
            return False
        os.replace(p, Path(str(p) + ".1"))
        return True
    except OSError:
        return False


def load_jsonl(path) -> tuple[list[dict], list[dict]]:
    """Split a metrics JSONL event log into (metric_log_records, snapshots).
    Unparseable lines are skipped (a crashed writer may leave a torn tail).
    A rotated sibling (``<path>.1``, see :func:`rotate_jsonl`) is read
    FIRST so records come back in write order across the rotation."""
    records: list[dict] = []
    snapshots: list[dict] = []
    main = Path(path)
    rotated = Path(str(path) + ".1")
    paths = [p for p in (rotated, main) if p.exists()]
    if not paths:
        raise FileNotFoundError(f"no event log at {path}")
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(obj, dict):
                    continue
                if obj.get("kind") == "registry_snapshot":
                    snapshots.append(obj)
                else:
                    records.append(obj)
    return records, snapshots


def load_trace(path) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict)]


# ------------------------------------------------------- snapshot accessors
def _metric_values(snap: dict, name: str) -> list[dict]:
    m = snap.get("metrics", {}).get(name)
    return m.get("values", []) if m else []


def snapshot_value(snap: dict, name: str, labels: dict | None = None) -> float | None:
    """First matching counter/gauge cell value in a snapshot, else None."""
    for row in _metric_values(snap, name):
        if labels is None or row.get("labels") == labels:
            if "value" in row:
                return row["value"]
    return None


def snapshot_total(snap: dict, name: str) -> float | None:
    """Sum over ALL label cells of a counter/gauge (e.g. the per-bucket
    ``serve.batches_total``); None when the metric has no cells."""
    values = [row["value"] for row in _metric_values(snap, name) if "value" in row]
    return sum(values) if values else None


def snapshot_histogram(snap: dict, name: str) -> dict | None:
    for row in _metric_values(snap, name):
        if "buckets" in row:
            return row
    return None


def histogram_quantile(row: dict, q: float) -> float | None:
    """Quantile from an exported snapshot histogram row — parses the
    ``{"le": count}`` dict into (bounds, counts) and delegates to
    :func:`obs.registry.quantile_from_counts`, the ONE
    estimator ``Histogram.quantile`` also uses."""
    from fedrec_tpu_torch.obs.registry import quantile_from_counts

    buckets = row.get("buckets", {})
    if not buckets or not row.get("count"):
        return None
    bounds: list[float] = []
    counts: list[int] = []
    inf_count = 0
    for le, n in buckets.items():
        if le == "+Inf":
            inf_count = n
        else:
            bounds.append(float(le))
            counts.append(n)
    order = sorted(range(len(bounds)), key=lambda i: bounds[i])
    bounds = [bounds[i] for i in order]
    counts = [counts[i] for i in order]
    counts.append(inf_count)
    return quantile_from_counts(q, bounds, counts)


def quantile_is_lower_bound(row: dict, q: float) -> bool:
    """True when the q-rank of an exported histogram row falls in the +Inf
    overflow bucket — :func:`histogram_quantile` then clamps to the last
    finite bucket edge, so the estimate is a LOWER BOUND, not a value
    (e.g. every observation above the largest bucket).  The report
    annotates such estimates with ``>=``."""
    buckets = row.get("buckets", {})
    total = sum(buckets.values())
    if total == 0:
        return False
    inf_count = buckets.get("+Inf", 0)
    return q * total > total - inf_count


def quality_detail_from_snapshot(snap: dict) -> dict:
    """The full quality digest out of one registry snapshot — every slice's
    metric quartet + impression count, the reliability table, score
    separation, and the serving drift verdict.  The ``fedrec-obs quality``
    verb renders this; ``build_report``'s Quality section is the compact
    subset."""
    detail: dict[str, Any] = {}
    slices: dict[str, dict] = {}
    for metric in ("auc", "mrr", "ndcg5", "ndcg10"):
        for row in _metric_values(snap, f"eval.{metric}"):
            if "value" in row:
                slices.setdefault(
                    row["labels"].get("slice", "?"), {}
                )[metric] = row["value"]
    for row in _metric_values(snap, "eval.slice_impressions"):
        if "value" in row:
            name = row["labels"].get("slice", "?")
            if name in slices:
                slices[name]["count"] = row["value"]
    if slices:
        detail["slices"] = dict(sorted(slices.items()))
    cal: dict[int, dict] = {}
    for key, name in (
        ("count", "eval.calibration_count"),
        ("confidence", "eval.calibration_confidence"),
        ("accuracy", "eval.calibration_accuracy"),
    ):
        for row in _metric_values(snap, name):
            if "value" in row:
                cal.setdefault(int(row["labels"].get("bin", -1)), {})[key] = (
                    row["value"]
                )
    if cal:
        detail["calibration"] = [
            {"bin": b, **cal[b]} for b in sorted(cal)
        ]
    for key, name in (
        ("ece", "eval.ece"),
        ("score_separation", "eval.score_separation"),
        ("score_dprime", "eval.score_dprime"),
        ("slices_skipped", "eval.slices_skipped_total"),
        ("quality_outlier_client_evals", "eval.quality_outlier_clients_total"),
    ):
        v = snapshot_value(snap, name)
        if v is not None:
            detail[key] = v
    clients = {
        row["labels"].get("client", "?"): row["value"]
        for row in _metric_values(snap, "eval.client_auc")
        if "value" in row
    }
    if clients:
        detail["client_auc"] = dict(sorted(clients.items()))
    drift = {
        key: v
        for key, name in (
            ("score_shift_mean", "serve.drift_score_shift_mean"),
            ("score_shift_max", "serve.drift_score_shift_max"),
            ("topk_jaccard", "serve.drift_topk_jaccard"),
            ("rank_churn", "serve.drift_rank_churn"),
            ("checks", "serve.drift_checks_total"),
        )
        if (v := snapshot_value(snap, name)) is not None
    }
    if drift:
        detail["drift"] = drift
    return detail


def perf_detail_from_snapshot(snap: dict) -> dict:
    """The performance digest out of one registry snapshot — the live
    efficiency gauges (obs.perf), the per-round roofline verdict counts,
    the HBM component attribution and the compile-cost table.  The
    ``fedrec-obs perf`` verb renders this; ``build_report``'s Perf
    section and the fleet report's per-worker perf columns are compact
    subsets of the SAME extraction."""
    detail: dict[str, Any] = {}
    for key, name in (
        ("samples_per_sec", "perf.samples_per_sec"),
        ("mfu", "perf.mfu"),
        ("hbm_fraction", "perf.hbm_fraction"),
        ("step_flops", "perf.step_flops"),
        ("host_ms_per_step", "perf.host_ms_per_step"),
        ("dispatch_ms_per_step", "perf.dispatch_ms_per_step"),
        ("captures", "perf.captures_total"),
        ("capture_failures", "perf.capture_failures_total"),
    ):
        v = (
            snapshot_total(snap, name)
            if name == "perf.captures_total"  # labeled per reason: sum
            else snapshot_value(snap, name)
        )
        if v is not None:
            detail[key] = v
    verdicts = {
        row["labels"].get("verdict", "?"): row["value"]
        for row in _metric_values(snap, "perf.roofline_rounds_total")
        if "value" in row and row["value"] > 0
    }
    if verdicts:
        detail["verdict_rounds"] = verdicts
        detail["verdict"] = max(verdicts, key=verdicts.get)
    hbm = {
        row["labels"].get("component", "?"): row["value"]
        for row in _metric_values(snap, "hbm.component_bytes")
        if "value" in row
    }
    if hbm:
        detail["hbm_components"] = hbm
    cost: dict[str, dict] = {}
    for key, name in (
        ("flops", "xla.cost_flops"),
        ("bytes_accessed", "xla.cost_bytes_accessed"),
        ("arithmetic_intensity", "xla.cost_arithmetic_intensity"),
    ):
        for row in _metric_values(snap, name):
            if "value" in row:
                cost.setdefault(row["labels"].get("fn", "?"), {})[key] = (
                    row["value"]
                )
    if cost:
        detail["compile_cost"] = dict(sorted(cost.items()))
    return detail


def span_summary(
    trace_events: list[dict], names: set | tuple | None = None
) -> dict[str, dict]:
    """Per-span-name `{count, total_ms, mean_ms, max_ms}` rollup over
    Chrome-trace complete ("X") events — THE aggregation behind
    ``build_report``'s span table and ``fedrec-obs perf``'s phase table
    (one definition, so the two views cannot drift on the same trace).
    ``names`` filters to a span subset (e.g. the round phases)."""
    spans: dict[str, dict] = {}
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        name = e.get("name")
        if names is not None and name not in names:
            continue
        s = spans.setdefault(
            name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
        )
        dur_ms = float(e.get("dur", 0.0)) / 1e3
        s["count"] += 1
        s["total_ms"] += dur_ms
        s["max_ms"] = max(s["max_ms"], dur_ms)
    for s in spans.values():
        s["total_ms"] = round(s["total_ms"], 3)
        s["max_ms"] = round(s["max_ms"], 3)
        s["mean_ms"] = round(s["total_ms"] / s["count"], 3) if s["count"] else 0.0
    return spans


# -------------------------------------------------------------- the report
def build_report(
    records: list[dict],
    snapshots: list[dict],
    trace_events: list[dict] | None = None,
) -> dict:
    report: dict[str, Any] = {}

    # ---- training rounds (MetricLogger schema: round + training_loss)
    rounds = [r for r in records if "round" in r and "training_loss" in r]
    if rounds:
        first, last = rounds[0], rounds[-1]
        elapsed = float(last.get("elapsed_sec", 0)) - float(first.get("elapsed_sec", 0))
        tr: dict[str, Any] = {
            "rounds": len(rounds),
            "first_loss": first["training_loss"],
            "last_loss": last["training_loss"],
        }
        if len(rounds) > 1 and elapsed > 0:
            tr["rounds_per_sec"] = round((len(rounds) - 1) / elapsed, 4)
        # unified key scheme (val_auc/val_mrr/val_ndcg5/val_ndcg10) with a
        # legacy fallback so pre-rename artifacts (valid_auc/val_ndcg@5)
        # still render
        _EVAL_KEYS = (
            ("val_auc", "valid_auc"),
            ("val_mrr", "valid_mrr"),
            ("val_ndcg5", "val_ndcg@5"),
            ("val_ndcg10", "val_ndcg@10"),
        )
        evals = [r for r in rounds if "val_auc" in r or "valid_auc" in r]
        if evals:
            last_ev = evals[-1]
            tr["last_eval"] = {
                new: (last_ev[new] if new in last_ev else last_ev[old])
                for new, old in _EVAL_KEYS
                if new in last_ev or old in last_ev
            }
        report["training"] = tr

    # ---- epsilon trajectory (per-round records and/or snapshots)
    def _round_key(r: dict):
        k = r.get("round", r.get("step"))
        # MetricLogger float-coerces numerics; a round index reads better whole
        return int(k) if isinstance(k, float) and k.is_integer() else k

    eps = [
        (_round_key(r), r["privacy.epsilon_spent"])
        for r in records
        if "privacy.epsilon_spent" in r
    ]
    if not eps:
        eps = [
            (i, v)
            for i, s in enumerate(snapshots)
            if (v := snapshot_value(s, "privacy.epsilon_spent")) is not None
        ]
    if eps:
        report["privacy"] = {
            "epsilon_trajectory": eps,
            "epsilon_spent": eps[-1][1],
        }

    last = snapshots[-1] if snapshots else None
    if last is not None:
        # ---- serving latency: prefer the collector gauges, fall back to
        # the histogram estimate
        p50 = snapshot_value(last, "serve.p50_ms")
        p99 = snapshot_value(last, "serve.p99_ms")
        hist = snapshot_histogram(last, "serve.latency_ms")
        serve: dict[str, Any] = {}
        if p50 is None and hist is not None:
            p50 = histogram_quantile(hist, 0.50)
            p99 = histogram_quantile(hist, 0.99)
            # all-mass-in-overflow (or a tail past the largest bucket):
            # the estimator clamps to the last finite edge — an honest
            # LOWER BOUND the report must say so about, not a value
            if p50 is not None and quantile_is_lower_bound(hist, 0.50):
                serve["p50_is_lower_bound"] = True
            if p99 is not None and quantile_is_lower_bound(hist, 0.99):
                serve["p99_is_lower_bound"] = True
        if p50 is not None:
            serve["p50_ms"] = round(p50, 3)
        if p99 is not None:
            serve["p99_ms"] = round(p99, 3)
        for key, name in (
            ("served", "serve.requests_total"),
            ("rejected", "serve.rejected_total"),
            ("deadline_missed", "serve.deadline_missed_total"),
            ("batches", "serve.batches_total"),  # labeled per bucket: sum
            ("queue_depth", "serve.queue_depth"),
            ("generation", "serve.generation"),
        ):
            v = snapshot_total(last, name) if key == "batches" \
                else snapshot_value(last, name)
            if v is not None:
                serve[key] = v
        if serve:
            report["serving"] = serve

        # ---- prefetch health
        pf = {
            key: v
            for key, name in (
                ("queue_depth", "data.prefetch.queue_depth"),
                ("producer_stalls", "data.prefetch.producer_stall_total"),
                ("consumer_stalls", "data.prefetch.consumer_stall_total"),
                ("items", "data.prefetch.items_total"),
            )
            if (v := snapshot_value(last, name)) is not None
        }
        if pf:
            report["prefetch"] = pf

        # ---- training health (numeric sentry + device watchdogs)
        health = {
            key: v
            for key, name, total in (
                ("nonfinite_steps", "health.nonfinite_steps_total", False),
                ("outlier_client_rounds", "health.outlier_clients_total", False),
                ("param_norm", "health.param_norm", False),
                ("clip_rate_last", "privacy.clip_rate_last", False),
                ("xla_compiles", "xla.compiles_total", True),       # per-fn: sum
                ("xla_recompiles", "xla.recompiles_total", True),
                ("recompile_storms", "xla.recompile_storms_total", False),
            )
            if (
                v := (snapshot_total(last, name) if total
                      else snapshot_value(last, name))
            ) is not None
        }
        if health:
            report["health"] = health

        # ---- robustness: chaos faults, quarantines/rollbacks, the
        # robust-aggregation method in use (label of the per-round counter)
        rb: dict[str, Any] = {}
        faults = {
            row["labels"].get("kind", "?"): row["value"]
            for row in _metric_values(last, "chaos.faults_total")
            if "value" in row
        }
        if faults:
            rb["faults_injected"] = faults
        for key, name in (
            ("quarantines", "fed.quarantines_total"),
            ("rollbacks", "fed.rollbacks_total"),
            ("quarantine_active", "fed.quarantine_active"),
        ):
            v = snapshot_value(last, name)
            if v:
                rb[key] = v
        methods = {
            row["labels"].get("method", "?"): row["value"]
            for row in _metric_values(last, "fed.robust_rounds_total")
            if "value" in row
        }
        if methods:
            rb["robust_method"] = max(methods, key=methods.get)
            rb["robust_rounds"] = sum(methods.values())
        if rb:
            report["robustness"] = rb

        # ---- participation: the cohort engine's view of the round —
        # population size, last cohort draw/report counts, cumulative
        # dropout/deadline/quorum events, slot churn, coverage. Keyed on
        # fed.population_clients > 0 so a cross-silo run stays silent.
        pop_size = snapshot_value(last, "fed.population_clients")
        if pop_size:
            part: dict[str, Any] = {"population": pop_size}
            for key, name in (
                ("cohort_sampled", "fed.cohort_sampled"),
                ("cohort_reporting", "fed.cohort_reporting"),
                ("dropouts", "fed.pop_dropouts_total"),
                ("deadline_cuts", "fed.deadline_cuts_total"),
                ("quorum_replays", "fed.quorum_replays_total"),
                ("slot_swaps", "fed.cohort_slot_swaps_total"),
                ("coverage", "fed.population_coverage"),
            ):
                v = snapshot_value(last, name)
                if v is not None:
                    part[key] = v
            report["participation"] = part

        # ---- communication: measured wire traffic — per-path byte
        # counters ("cohort" = the simulated in-graph client uplink,
        # counted only under an active codec; "dcn" = the coordinator's
        # real cross-host gather, counted in EVERY mode, dense bytes
        # included) plus the per-client compression ratio. Keyed on any
        # up-bytes having been counted: single-process runs without a
        # codec stay silent, a multi-process run always shows its DCN
        # bytes.
        up_by_path = {
            row["labels"].get("path", "?"): row["value"]
            for row in _metric_values(last, "fed.dcn_bytes_up_total")
            if "value" in row and row["value"] > 0
        }
        if up_by_path:
            comm: dict[str, Any] = {
                "bytes_up": up_by_path,
                "bytes_up_total": sum(up_by_path.values()),
            }
            down_by_path = {
                row["labels"].get("path", "?"): row["value"]
                for row in _metric_values(last, "fed.dcn_bytes_down_total")
                if "value" in row and row["value"] > 0
            }
            if down_by_path:
                comm["bytes_down"] = down_by_path
                comm["bytes_down_total"] = sum(down_by_path.values())
            ratio = snapshot_value(last, "fed.dcn_compression_ratio")
            if ratio:
                comm["compression_ratio"] = ratio
            else:
                # explicit "codec: none": this artifact moved DENSE
                # traffic — absent-because-uncompressed, not
                # absent-because-unmeasured (operators diffing two
                # reports must see which side ran a codec)
                comm["codec"] = "none"
            per_leaf = {
                row["labels"].get("leaf", "?"): row["value"]
                for row in _metric_values(
                    last, "fed.dcn_compression_ratio_leaf"
                )
                if "value" in row
            }
            if per_leaf:
                comm["compression_ratio_by_leaf"] = per_leaf
            srmse = snapshot_value(last, "fed.dcn_sketch_rmse")
            if srmse is not None:
                comm["sketch_rmse"] = srmse
            auto_map = next(
                (
                    r["dcn_auto_map_pinned"]
                    for r in reversed(records)
                    if "dcn_auto_map_pinned" in r
                ),
                None,
            )
            if isinstance(auto_map, str):
                # the trainer logs the map as a JSON string (the metric
                # logger stringifies anything non-numeric)
                try:
                    auto_map = json.loads(auto_map)
                except json.JSONDecodeError:
                    auto_map = None
            if isinstance(auto_map, dict) and auto_map:
                comm["auto_codec_map"] = auto_map
            misses = snapshot_value(last, "fed.dcn_deadline_misses_total")
            if misses:
                comm["deadline_misses"] = misses
            report["communication"] = comm

        # ---- sharding: the layout summary — fsdp shards + at-rest state
        # bytes per device, sharded-catalog occupancy/residency, and the
        # modeled owner-bucketed all_to_all traffic. Keyed on the layout
        # actually being sharded (fsdp > 1 or a per-step a2a wire model),
        # so a replicated run stays silent.
        fsdp = snapshot_value(last, "shard.fsdp_shards")
        a2a = snapshot_value(last, "shard.a2a_bytes_total")
        if (fsdp and fsdp > 1) or a2a:
            sh: dict[str, Any] = {}
            if fsdp:
                sh["fsdp_shards"] = fsdp
            for key, name in (
                ("state_bytes_per_device", "shard.state_bytes_per_device"),
                ("table_rows_per_device", "shard.table_rows_per_device"),
                ("table_occupancy", "shard.table_occupancy"),
                ("remote_gather_rows", "shard.remote_gather_rows"),
                ("a2a_bytes", "shard.a2a_bytes_total"),
            ):
                v = snapshot_value(last, name)
                if v is not None:
                    sh[key] = v
            report["sharding"] = sh

        # ---- membership: the elastic epoch layer's view — this worker's
        # epoch/world seat, the service-mirrored shrink/rejoin/lease-miss
        # totals, its own reform departures and heartbeat failures, and
        # the reshard cost of the last epoch hand-off. Keyed on the epoch
        # gauge existing: a fixed-world run stays silent.
        epoch = snapshot_value(last, "fed.membership_epoch")
        if epoch is not None:
            mem: dict[str, Any] = {"epoch": epoch}
            # shrinks/rejoins/lease_misses: the service's OWN counters
            # (its obs trio, PR-13) — the `_total` names; the legacy
            # pre-PR-13 worker-mirrored gauge names still render from
            # old artifacts
            for key, names in (
                ("world", ("fed.membership_world",)),
                ("shrinks", ("fed.membership_shrinks_total",
                             "fed.membership_shrinks")),
                ("rejoins", ("fed.membership_rejoins_total",
                             "fed.membership_rejoins")),
                ("lease_misses", ("fed.membership_lease_misses_total",
                                  "fed.membership_lease_misses")),
                ("heartbeat_failures", ("fed.lease_heartbeat_failures",)),
                ("reforms", ("fed.membership_reforms_total",)),
                ("reshard_seconds", ("shard.reshard_seconds",)),
                ("rows_recovered", ("shard.reshard_rows_recovered_total",)),
            ):
                for name in names:
                    v = snapshot_value(last, name)
                    if v is not None:
                        mem[key] = v
                        break
            report["membership"] = mem

        # ---- quality: sliced eval telemetry + calibration + serving
        # drift (obs.quality) — the compact subset of ONE extraction
        # (quality_detail_from_snapshot, shared with `fedrec-obs quality`
        # and the fleet report), so the three views can never disagree;
        # silent (empty detail) on a quality-off run
        detail = quality_detail_from_snapshot(last)
        if detail:
            ql: dict[str, Any] = {}
            slices_d = {
                name: m for name, m in detail.get("slices", {}).items()
                if "auc" in m
            }
            if slices_d:
                ql["slices"] = {
                    name: {
                        "auc": m["auc"],
                        **({"count": m["count"]} if "count" in m else {}),
                    }
                    for name, m in slices_d.items()
                }
                if "all" in slices_d:
                    ql["corpus_auc"] = slices_d["all"]["auc"]
                named = {
                    k: m["auc"] for k, m in slices_d.items() if k != "all"
                }
                if named:
                    ql["worst_slice"] = min(named, key=named.get)
                    ql["best_slice"] = max(named, key=named.get)
            for key in (
                "ece", "score_separation", "score_dprime",
                "quality_outlier_client_evals", "slices_skipped",
            ):
                if key in detail:
                    ql[key] = detail[key]
            if "drift" in detail:
                ql["drift"] = detail["drift"]
            report["quality"] = ql

        # ---- perf: the live efficiency gauges (obs.perf) — throughput,
        # MFU, the roofline-verdict round counts, HBM attribution and
        # compile cost, compacted from ONE extraction
        # (perf_detail_from_snapshot, shared with `fedrec-obs perf` and
        # the fleet report); silent on a perf-off run
        pdetail = perf_detail_from_snapshot(last)
        if pdetail:
            pf_sec: dict[str, Any] = {}
            for key in (
                "samples_per_sec", "mfu", "hbm_fraction",
                "host_ms_per_step", "dispatch_ms_per_step",
                "verdict", "verdict_rounds", "captures",
            ):
                if key in pdetail:
                    pf_sec[key] = pdetail[key]
            if "hbm_components" in pdetail:
                comps = {
                    k: v for k, v in pdetail["hbm_components"].items() if v
                }
                if comps:
                    pf_sec["hbm_top"] = max(comps, key=comps.get)
                    pf_sec["hbm_components"] = comps
            if "compile_cost" in pdetail:
                pf_sec["compiled_fns"] = len(pdetail["compile_cost"])
            if pf_sec:
                report["perf"] = pf_sec

        # ---- cap overflows
        overflow = snapshot_value(last, "train.cap_overflow_total")
        if overflow is not None:
            report["cap_overflow_steps"] = overflow

    # ---- alert lifecycle (the watch layer's {"kind": "alert"} records;
    # silent on a run with obs.slo.enabled=false: no records, no panel)
    from fedrec_tpu_torch.obs.watch import active_alerts, alert_records

    alerts = alert_records(records)
    if alerts:
        by_event: dict[str, int] = {}
        for r in alerts:
            ev = str(r.get("event", "?"))
            by_event[ev] = by_event.get(ev, 0) + 1
        report["alerts"] = {
            "transitions": len(alerts),
            "by_event": by_event,
            "active": active_alerts(alerts),
            "recent": alerts[-8:],
        }

    # ---- kernel builds (obs.device.BuildWatch): the port's counterpart of
    # the JAX package's XLA compile counters
    if snapshots:
        builds = {row["labels"].get("kernel", "?"): row["value"]
                  for row in _metric_values(snapshots[-1], "kernel.build_seconds")
                  if "value" in row}
        if builds:
            report["kernels"] = {
                "builds": snapshot_total(snapshots[-1], "kernel.builds_total") or 0.0,
                "build_seconds": dict(sorted(builds.items())),
            }

    # ---- span summary
    if trace_events:
        report["spans"] = dict(sorted(span_summary(trace_events).items()))

    return report


def render_text(report: dict) -> str:
    """Human-readable run report (the ``fedrec-obs report`` output)."""
    lines: list[str] = ["# fedrec_tpu_torch run report", ""]
    tr = report.get("training")
    if tr:
        lines.append("## Training")
        lines.append(f"rounds: {tr['rounds']}")
        if "rounds_per_sec" in tr:
            lines.append(f"round throughput: {tr['rounds_per_sec']} rounds/s")
        lines.append(f"loss: {tr['first_loss']:.4f} -> {tr['last_loss']:.4f}")
        if "last_eval" in tr:
            ev = ", ".join(f"{k}={v:.4f}" for k, v in tr["last_eval"].items())
            lines.append(f"last eval: {ev}")
        lines.append("")
    pv = report.get("privacy")
    if pv:
        lines.append("## Privacy")
        lines.append(f"privacy.epsilon_spent: {pv['epsilon_spent']:.4f}")
        traj = ", ".join(f"r{r}={e:.3f}" for r, e in pv["epsilon_trajectory"][-8:])
        lines.append(f"trajectory (last 8): {traj}")
        lines.append("")
    sv = report.get("serving")
    if sv:
        lines.append("## Serving")
        if "p50_ms" in sv or "p99_ms" in sv:
            p50_pfx = ">=" if sv.get("p50_is_lower_bound") else ""
            p99_pfx = ">=" if sv.get("p99_is_lower_bound") else ""
            lines.append(
                f"latency: p50={p50_pfx}{sv.get('p50_ms')}ms "
                f"p99={p99_pfx}{sv.get('p99_ms')}ms"
            )
        counters = ", ".join(
            f"{k}={int(sv[k])}"
            for k in ("served", "rejected", "deadline_missed", "batches")
            if k in sv
        )
        if counters:
            lines.append(counters)
        if "queue_depth" in sv:
            lines.append(f"queue depth: {int(sv['queue_depth'])}")
        lines.append("")
    pf = report.get("prefetch")
    if pf:
        lines.append("## Prefetch")
        lines.append(
            "queue depth: "
            f"{int(pf.get('queue_depth', 0))}, producer stalls: "
            f"{int(pf.get('producer_stalls', 0))}, consumer stalls: "
            f"{int(pf.get('consumer_stalls', 0))}"
        )
        lines.append("")
    hl = report.get("health")
    if hl:
        lines.append("## Health")
        if "nonfinite_steps" in hl:
            lines.append(f"non-finite step cells: {int(hl['nonfinite_steps'])}")
        if "outlier_client_rounds" in hl:
            lines.append(
                f"outlier client-rounds: {int(hl['outlier_client_rounds'])}"
            )
        if "param_norm" in hl:
            lines.append(f"param norm (last): {hl['param_norm']:.4g}")
        if "clip_rate_last" in hl:
            lines.append(f"dp clip rate (last step): {hl['clip_rate_last']:.4f}")
        if "xla_compiles" in hl:
            lines.append(
                f"xla compiles: {int(hl['xla_compiles'])} "
                f"(recompiles: {int(hl.get('xla_recompiles', 0))}, "
                f"storms: {int(hl.get('recompile_storms', 0))})"
            )
        lines.append("")
    al = report.get("alerts")
    if al:
        lines.append("## Alerts")
        by = ", ".join(f"{k}={v}" for k, v in sorted(al["by_event"].items()))
        lines.append(f"transitions: {al['transitions']} ({by})")
        if al["active"]:
            lines.append(f"STILL FIRING ({len(al['active'])}):")
            for r in al["active"]:
                lines.append(f"  [{r.get('severity', '?')}] {r.get('key', '?')}: "
                             f"{r.get('summary', '')}")
        else:
            lines.append("active: none (every fired alert resolved)")
        lines.append("")
    kb = report.get("kernels")
    if kb:
        lines.append("## Kernel builds")
        lines.append(f"builds: {int(kb['builds'])}")
        for name, sec in kb["build_seconds"].items():
            lines.append(f"  {name}: {sec:.2f} s")
        lines.append("")
    rb = report.get("robustness")
    if rb:
        lines.append("## Robustness")
        if "robust_method" in rb:
            lines.append(
                f"aggregation: {rb['robust_method']} "
                f"({int(rb.get('robust_rounds', 0))} rounds)"
            )
        if "faults_injected" in rb:
            lines.append(
                "faults injected: "
                + ", ".join(
                    f"{k}={int(v)}"
                    for k, v in sorted(rb["faults_injected"].items())
                )
            )
        if "quarantines" in rb or "rollbacks" in rb:
            lines.append(
                f"clients quarantined: {int(rb.get('quarantines', 0))}, "
                f"rollbacks: {int(rb.get('rollbacks', 0))}, "
                f"active: {int(rb.get('quarantine_active', 0))}"
            )
        lines.append("")
    part = report.get("participation")
    if part:
        lines.append("## Participation")
        lines.append(
            f"logical clients: {int(part['population'])}"
            + (
                f", coverage: {part['coverage']:.1%}"
                if "coverage" in part else ""
            )
        )
        if "cohort_sampled" in part or "cohort_reporting" in part:
            lines.append(
                f"last round: sampled={int(part.get('cohort_sampled', 0))} "
                f"reporting={int(part.get('cohort_reporting', 0))}"
            )
        lines.append(
            f"dropouts: {int(part.get('dropouts', 0))}, "
            f"deadline cuts: {int(part.get('deadline_cuts', 0))}, "
            f"quorum replays: {int(part.get('quorum_replays', 0))}, "
            f"slot swaps: {int(part.get('slot_swaps', 0))}"
        )
        lines.append("")
    comm = report.get("communication")
    if comm:
        lines.append("## Communication")

        def _mb(n: float) -> str:
            return f"{n / (1024 * 1024):.2f} MB"

        up = ", ".join(
            f"{p}={_mb(v)}" for p, v in sorted(comm["bytes_up"].items())
        )
        lines.append(f"client->server bytes: {up}")
        if "bytes_down" in comm:
            down = ", ".join(
                f"{p}={_mb(v)}" for p, v in sorted(comm["bytes_down"].items())
            )
            lines.append(f"server->client bytes: {down} (full precision)")
        if "compression_ratio" in comm:
            lines.append(
                f"update compression: {comm['compression_ratio']:.1f}x "
                "(dense/encoded, per client-round payload)"
            )
        else:
            lines.append("codec: none (dense payloads — no compression ran)")
        if "compression_ratio_by_leaf" in comm:
            cells = ", ".join(
                f"{leaf}={v:.1f}x"
                for leaf, v in sorted(
                    comm["compression_ratio_by_leaf"].items()
                )
            )
            lines.append(f"per-layer compression: {cells}")
        if "sketch_rmse" in comm:
            lines.append(
                f"sketch reconstruction rmse: {comm['sketch_rmse']:.3e} "
                "(own decoded contribution vs dense, pooled)"
            )
        if "auto_codec_map" in comm:
            picks = ", ".join(
                f"{leaf}:{c}"
                for leaf, c in sorted(comm["auto_codec_map"].items())
            )
            lines.append(f"auto codec map (pinned): {picks}")
        if "deadline_misses" in comm:
            lines.append(f"dcn deadline misses: {int(comm['deadline_misses'])}")
        lines.append("")
    shd = report.get("sharding")
    if shd:
        lines.append("## Sharding")

        def _mib(n: float) -> str:
            return f"{n / (1024 * 1024):.2f} MB"

        layout = []
        if shd.get("fsdp_shards"):
            layout.append(f"fsdp shards: {int(shd['fsdp_shards'])}")
        if "state_bytes_per_device" in shd:
            layout.append(
                f"state/device: {_mib(shd['state_bytes_per_device'])}"
            )
        if layout:
            lines.append(", ".join(layout))
        if "table_rows_per_device" in shd:
            occ = (
                f", occupancy: {shd['table_occupancy']:.1%}"
                if "table_occupancy" in shd else ""
            )
            lines.append(
                f"catalog rows/device: {int(shd['table_rows_per_device'])}"
                + occ
            )
        if "a2a_bytes" in shd:
            remote = (
                f" (worst-case {int(shd['remote_gather_rows'])} remote "
                "rows/step)"
                if "remote_gather_rows" in shd else ""
            )
            lines.append(
                f"gather all_to_all: {_mib(shd['a2a_bytes'])}{remote}"
            )
        lines.append("")
    mem = report.get("membership")
    if mem:
        lines.append("## Membership")
        lines.append(
            f"epoch: {int(mem['epoch'])}"
            + (f", world: {int(mem['world'])}" if "world" in mem else "")
        )
        lines.append(
            f"shrinks: {int(mem.get('shrinks', 0))}, "
            f"rejoins: {int(mem.get('rejoins', 0))}, "
            f"reform departures (this worker): {int(mem.get('reforms', 0))}"
        )
        lines.append(
            f"lease misses: {int(mem.get('lease_misses', 0))}, "
            f"heartbeat failures: {int(mem.get('heartbeat_failures', 0))}"
        )
        if "reshard_seconds" in mem:
            rows = (
                f", rows recovered: {int(mem['rows_recovered'])}"
                if "rows_recovered" in mem else ""
            )
            lines.append(
                f"last epoch hand-off: {mem['reshard_seconds']:.3f}s{rows}"
            )
        lines.append("")
    ql = report.get("quality")
    if ql:
        lines.append("## Quality")
        slices = ql.get("slices", {})
        if "corpus_auc" in ql:
            n = slices.get("all", {}).get("count")
            over = f" over {int(n)} impressions" if n is not None else ""
            lines.append(f"corpus auc: {ql['corpus_auc']:.4f}{over}")
        if "worst_slice" in ql:
            w, b = ql["worst_slice"], ql["best_slice"]
            n_named = len(slices) - (1 if "all" in slices else 0)
            lines.append(
                f"slices: {n_named} — worst {w} "
                f"auc={slices[w]['auc']:.4f}, best {b} "
                f"auc={slices[b]['auc']:.4f}"
            )
        if "slices_skipped" in ql and ql["slices_skipped"]:
            lines.append(
                f"slices skipped (empty/degenerate): "
                f"{int(ql['slices_skipped'])}"
            )
        if "ece" in ql:
            lines.append(f"calibration: ece={ql['ece']:.4f}")
        if "score_separation" in ql:
            dp = (
                f" (d'={ql['score_dprime']:.3f})"
                if "score_dprime" in ql else ""
            )
            lines.append(
                f"score separation: {ql['score_separation']:.4f}{dp}"
            )
        if "quality_outlier_client_evals" in ql:
            lines.append(
                "quality-outlier client-evals: "
                f"{int(ql['quality_outlier_client_evals'])}"
            )
        dr = ql.get("drift")
        if dr:
            parts = []
            if "score_shift_mean" in dr:
                parts.append(
                    f"|Δscore| mean={dr['score_shift_mean']:.4g} "
                    f"max={dr.get('score_shift_max', 0):.4g}"
                )
            if "topk_jaccard" in dr:
                parts.append(
                    f"top-k jaccard={dr['topk_jaccard']:.3f} "
                    f"(churn {dr.get('rank_churn', 0):.3f})"
                )
            lines.append(
                f"serving drift (last swap, {int(dr.get('checks', 0))} "
                f"probe check(s)): " + ", ".join(parts)
            )
        lines.append("")
    pfm = report.get("perf")
    if pfm:
        lines.append("## Perf")
        head = []
        if "samples_per_sec" in pfm:
            head.append(f"throughput: {pfm['samples_per_sec']:.1f} samples/s")
        if "mfu" in pfm:
            head.append(f"mfu: {pfm['mfu']:.4f}")
        if "hbm_fraction" in pfm:
            head.append(f"hbm: {pfm['hbm_fraction']:.3f} of peak")
        if head:
            lines.append(", ".join(head) + " (last round)")
        if "host_ms_per_step" in pfm or "dispatch_ms_per_step" in pfm:
            lines.append(
                f"per step: host {pfm.get('host_ms_per_step', 0):.2f} ms, "
                f"dispatch {pfm.get('dispatch_ms_per_step', 0):.2f} ms"
            )
        if "verdict_rounds" in pfm:
            counts = ", ".join(
                f"{k}={int(v)}"
                for k, v in sorted(pfm["verdict_rounds"].items())
            )
            lines.append(f"roofline verdicts (rounds): {counts}")
        if "hbm_components" in pfm:
            def _cmb(n: float) -> str:
                return f"{n / (1024 * 1024):.1f} MB"

            comps = ", ".join(
                f"{k}={_cmb(v)}"
                for k, v in sorted(
                    pfm["hbm_components"].items(),
                    key=lambda kv: -kv[1],
                )
            )
            lines.append(f"hbm by component: {comps}")
        if "captures" in pfm and pfm["captures"]:
            lines.append(
                f"capture windows: {int(pfm['captures'])} "
                "(see perf_capture_* under the obs dir)"
            )
        if "compiled_fns" in pfm:
            lines.append(
                f"compile-cost rows: {int(pfm['compiled_fns'])} "
                "(fedrec-obs perf for the table)"
            )
        lines.append("")
    if "cap_overflow_steps" in report:
        lines.append(f"cap-overflow steps: {int(report['cap_overflow_steps'])}")
        lines.append("")
    spans = report.get("spans")
    if spans:
        lines.append("## Host spans")
        lines.append(f"{'name':<24} {'count':>7} {'total_ms':>10} {'mean_ms':>9} {'max_ms':>9}")
        for name, s in spans.items():
            lines.append(
                f"{name:<24} {s['count']:>7} {s['total_ms']:>10} "
                f"{s['mean_ms']:>9} {s['max_ms']:>9}"
            )
        lines.append("")
    if len(lines) == 2:
        lines.append("(no recognizable records — is this a fedrec obs artifact?)")
    return "\n".join(lines)


def dump_artifacts(
    obs_dir, registry=None, tracer=None, trace_tag: str | None = None
) -> dict[str, str]:
    """Write the run's observability artifacts into ``obs_dir``:
    ``metrics.jsonl`` (append one final registry snapshot), ``trace.json``
    (Perfetto host spans), ``prometheus.txt`` (text exposition).  Shared
    shutdown path for the Trainer, ``fedrec-serve`` and ``serve_load``.

    ``trace_tag`` additionally writes the trace as ``trace_<tag>.json``
    (an elastic coordinator worker tags each epoch's incarnation)."""
    from fedrec_tpu_torch.obs.registry import get_registry
    from fedrec_tpu_torch.obs.tracing import get_tracer

    registry = registry or get_registry()
    tracer = tracer or get_tracer()
    out_dir = Path(obs_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {
        "metrics": str(out_dir / "metrics.jsonl"),
        "trace": str(out_dir / "trace.json"),
        "prometheus": str(out_dir / "prometheus.txt"),
    }
    registry.write_snapshot(paths["metrics"])
    tracer.save(paths["trace"])
    if trace_tag:
        tagged = str(out_dir / f"trace_{trace_tag}.json")
        paths["trace_tagged"] = tagged
        tracer.save(tagged)
    with open(paths["prometheus"], "w") as f:
        f.write(registry.to_prometheus())
    return paths
