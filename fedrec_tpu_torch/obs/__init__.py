"""Telemetry for the port: a copy of ``fedrec_tpu.obs``.

* ``obs.registry``: the process-wide metrics registry (counters, gauges,
  fixed-bucket histograms; labelled, thread-safe, snapshot-able) and its
  Prometheus text exposition;
* ``obs.tracing``: host spans, saved as a Chrome-trace/Perfetto JSON;
* ``obs.health``: the training-health monitor over the train step's
  numeric sentry (``HealthMonitor``, ``TrainingHealthError``) and the
  flight recorder (``FlightRecorder``);
* ``obs.quality``: sliced evaluation, calibration, the per-client quality
  digest (``QualityMonitor``) and the serving store's ``DriftProbe``;
* ``obs.perf``: the FLOPs model, the card's peaks, ``PerfMonitor`` and its
  ``torch.profiler`` capture windows;
* ``obs.device``: device-memory gauges and the native builds' counts;
* ``obs.report``: the artifacts' readers, the run report and
  ``dump_artifacts`` (``metrics.jsonl``, ``trace.json``, ``prometheus.txt``
  under ``obs.dir``);
* ``obs.fleet``: the fleet identity (``set_fleet_identity``), the
  control plane's JSON-lines exchange, the telemetry collector and pusher,
  the counter baseline, and the offline merger (clock-aligned fleet trace,
  critical path, the fleet report);
* ``obs.wire``: the wire envelope (trace context, per-edge RTT and bytes,
  NTP-style clock offsets);
* ``obs.alerts`` and ``obs.watch``: the alert lifecycle, declarative SLOs
  with burn rates, the anomaly detector and the fleet rules.

``fedrec_tpu_torch.cli.obs`` (``fedrec-obs``) renders, merges and replays
them. The fleet modules import no torch; the package imports them only on
use, so ``python -m fedrec_tpu_torch.obs.fleet`` runs the collector.
"""

from fedrec_tpu_torch.obs.health import (
    CLIP_RATE_BUCKETS,
    NORM_BUCKETS,
    FlightRecorder,
    HealthMonitor,
    TrainingHealthError,
)
from fedrec_tpu_torch.obs.quality import DriftProbe, QualityMonitor
from fedrec_tpu_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
    snapshot_to_prometheus,
)
from fedrec_tpu_torch.obs.report import (
    build_report,
    dump_artifacts,
    load_jsonl,
    load_trace,
    render_text,
    rotate_jsonl,
)
from fedrec_tpu_torch.obs.tracing import Tracer, get_tracer, set_tracer

__all__ = [
    "CLIP_RATE_BUCKETS",
    "DEFAULT_BUCKETS",
    "NORM_BUCKETS",
    "Counter",
    "DriftProbe",
    "FlightRecorder",
    "Gauge",
    "HealthMonitor",
    "Histogram",
    "MetricsRegistry",
    "QualityMonitor",
    "Tracer",
    "TrainingHealthError",
    "build_report",
    "dump_artifacts",
    "get_registry",
    "get_tracer",
    "load_jsonl",
    "load_trace",
    "render_text",
    "rotate_jsonl",
    "set_registry",
    "set_tracer",
    "snapshot_to_prometheus",
]
