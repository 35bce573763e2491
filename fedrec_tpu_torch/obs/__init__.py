"""Telemetry for the port: a copy of the single-process parts of
``fedrec_tpu.obs``.

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
  under ``obs.dir``).

``fedrec_tpu_torch.cli.obs`` (``fedrec-obs``) renders and replays them.
``obs.fleet`` holds only the control plane's JSON-lines exchange (the
membership service's wire); the fleet telemetry, wire, watch and alert
layers need several processes (``ROADMAP.md`` Queue A item 10b).
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
