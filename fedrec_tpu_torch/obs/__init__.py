"""Telemetry for the port: a copy of the parts of ``fedrec_tpu.obs`` that the
ported serving and training paths call.

* ``obs.registry`` — the process-wide metrics registry (counters, gauges,
  fixed-bucket histograms; labelled, thread-safe, snapshot-able);
* ``obs.tracing`` — host spans in a bounded in-memory list;
* ``obs.health`` — the training-health monitor over the train step's
  numeric sentry (``HealthMonitor``, ``TrainingHealthError``);
* ``obs.quality`` — the serving store's pre-swap ``DriftProbe``.

The file artifacts (``obs.dir``: the event log, the trace export, the
reports, the flight recorder) are ``ROADMAP.md`` Queue A item 10b.
"""

from fedrec_tpu_torch.obs.health import (
    CLIP_RATE_BUCKETS,
    NORM_BUCKETS,
    HealthMonitor,
    TrainingHealthError,
)
from fedrec_tpu_torch.obs.quality import DriftProbe
from fedrec_tpu_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from fedrec_tpu_torch.obs.tracing import Tracer, get_tracer, set_tracer

__all__ = [
    "CLIP_RATE_BUCKETS",
    "DEFAULT_BUCKETS",
    "NORM_BUCKETS",
    "Counter",
    "DriftProbe",
    "Gauge",
    "HealthMonitor",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "TrainingHealthError",
    "get_registry",
    "get_tracer",
    "set_registry",
    "set_tracer",
]
