"""Metric logging with the obs registry as backend, the port of
``fedrec_tpu/utils/logging.py`` without its wandb exporter.

Every ``log()`` call:

* publishes each numeric metric as a gauge in the registry (so snapshots
  and the Prometheus exposition carry the training schema);
* writes one JSON line (``{"step", "elapsed_sec", **fleet, **metrics}``,
  the registry's fleet labels included, a metric key winning) to
  ``stream`` when one is given, and to ``jsonl_path`` when given (the run's
  event log, which ``fedrec-obs report`` reads), appended and closed each
  time, so a killed run keeps every line and a size rotation
  (``jsonl_max_mb``) never leaves a stale handle;
* stringifies values that are not float-coercible.
"""

from __future__ import annotations

import json
import time
from typing import Any

from fedrec_tpu_torch.obs.registry import get_registry


class MetricLogger:
    def __init__(self, stream=None, jsonl_path: str | None = None, registry=None,
                 jsonl_max_mb: float = 0.0):
        self.stream = stream
        self._t0 = time.time()
        self._registry = registry or get_registry()
        self._records = self._registry.counter("log.records_total", "metric-log records emitted")
        self._jsonl_path = jsonl_path
        self._jsonl_max_mb = float(jsonl_max_mb or 0.0)
        if jsonl_path:
            open(jsonl_path, "a").close()  # fail fast on an unwritable path

    def log(self, step: int, metrics: dict[str, Any]) -> dict:
        """Emit one record; returns it."""
        numeric: dict[str, float] = {}
        clean: dict[str, Any] = {}
        for k, v in metrics.items():
            if hasattr(v, "__float__"):
                try:
                    f = float(v)
                except (TypeError, ValueError):
                    clean[k] = str(v)
                    continue
                numeric[k] = f
                clean[k] = f
            else:
                clean[k] = v if isinstance(v, str) or v is None else str(v)
        # fleet correlation keys (obs.fleet): worker / rank / membership epoch
        record = {"step": step, "elapsed_sec": round(time.time() - self._t0, 2),
                  **self._registry.context, **clean}
        line = json.dumps(record)
        if self.stream is not None:
            print(line, file=self.stream, flush=True)
        if self._jsonl_path is not None:
            if self._jsonl_max_mb > 0:
                from fedrec_tpu_torch.obs.report import rotate_jsonl

                rotate_jsonl(self._jsonl_path, self._jsonl_max_mb)
            with open(self._jsonl_path, "a") as f:
                f.write(line + "\n")
        for k, f in numeric.items():
            try:
                self._registry.gauge(k).set(f)
            except ValueError:
                pass  # the name is already another kind of instrument
        self._records.inc()
        return record

    def finish(self) -> None:
        self._jsonl_path = None
