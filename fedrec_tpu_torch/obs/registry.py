"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``fedrec_tpu/obs/registry.py`` (the port imports nothing of the
JAX package), without its Prometheus exposition, which comes with the rest
of the observability artifacts (``ROADMAP.md`` Queue A item 10b).

* Names are dotted (``serve.p50_ms``, ``health.grad_norm``).
* Get-or-create is idempotent: ``registry.counter("x")`` from two modules
  returns the same instrument; re-registering a name as another kind, with
  other label names or other buckets raises.
* Histograms use fixed upper-bound buckets with Prometheus ``le``
  semantics (inclusive); ``merge_counts`` adds a whole array's bucket
  counts under one lock (``obs.health`` publishes a round's cells at once).
* Collectors run just before a snapshot, to refresh derived gauges.

``get_registry`` is the process's default registry; tests swap in a fresh
one with ``set_registry``.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Mapping, Sequence

# default latency-flavoured buckets (ms); callers pass their own for other units
DEFAULT_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0
)


class _Metric:
    """Shared instrument plumbing: per-label-set cells behind one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._cells: dict[tuple, Any] = {}

    def _key(self, labels: Mapping[str, Any]) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def _label_dict(self, key: tuple) -> dict[str, str]:
        return dict(zip(self.label_names, key))

    def _snapshot_values(self) -> list[dict]:
        with self._lock:
            return [{"labels": self._label_dict(k), "value": v}
                    for k, v in sorted(self._cells.items())]


class Counter(_Metric):
    """Monotonic accumulator: ``inc`` only."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._cells.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._cells[key] = float(value)

    def value(self, **labels) -> float | None:
        with self._lock:
            v = self._cells.get(self._key(labels))
            return None if v is None else float(v)


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the implicit +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram with Prometheus ``le`` (inclusive) semantics:
    ``buckets`` are the finite upper bounds, strictly increasing, the
    ``+Inf`` bucket implicit; a value equal to a bound lands in its bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram {name!r} buckets must be non-empty and strictly "
                f"increasing, got {bs}"
            )
        if any(math.isinf(b) or math.isnan(b) for b in bs):
            raise ValueError(f"histogram {name!r} buckets must be finite (+Inf is implicit)")
        self.buckets = bs

    def _cell(self, key: tuple) -> _HistCell:
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _HistCell(len(self.buckets))
        return cell

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = self._key(labels)
        # the first bucket whose bound is >= value: the inclusive bucket
        idx = bisect_left(self.buckets, value)
        with self._lock:
            cell = self._cell(key)
            cell.counts[idx] += 1
            cell.sum += value
            cell.count += 1

    def merge_counts(self, counts: Sequence[int], sum: float, count: int, **labels) -> None:
        """Add precomputed per-bucket counts (+Inf bucket last, so
        ``len(counts) == len(buckets) + 1``) under one lock acquire: the
        vectorized observe of a whole array."""
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"histogram {self.name!r} expects {len(self.buckets) + 1} "
                f"bucket counts (+Inf last), got {len(counts)}"
            )
        key = self._key(labels)
        with self._lock:
            cell = self._cell(key)
            for i, c in enumerate(counts):
                cell.counts[i] += int(c)
            cell.sum += float(sum)
            cell.count += int(count)

    def cell(self, **labels) -> dict | None:
        key = self._key(labels)
        with self._lock:
            c = self._cells.get(key)
            if c is None:
                return None
            return {"sum": c.sum, "count": c.count, "counts": list(c.counts)}

    def _snapshot_values(self) -> list[dict]:
        with self._lock:
            return [{
                "labels": self._label_dict(k),
                "sum": c.sum,
                "count": c.count,
                "buckets": {
                    ("+Inf" if i == len(self.buckets) else repr(self.buckets[i])): n
                    for i, n in enumerate(c.counts)
                },
            } for k, c in sorted(self._cells.items())]


class MetricsRegistry:
    """Named instruments and collectors: the process's one metrics namespace."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} with "
                        f"labels {m.label_names}; cannot re-register as "
                        f"{cls.kind} with labels {tuple(labels)}"
                    )
                want = kw.get("buckets")
                if want is not None and m.buckets != tuple(float(b) for b in want):
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{m.buckets}; cannot re-register with {tuple(want)}"
                    )
                return m
            m = self._metrics[name] = cls(name, help, labels, **kw)
            return m

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs (best effort) before every snapshot."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def snapshot(self) -> dict:
        """One JSON-serializable dict of every instrument's current state."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — telemetry must never take down the host
                pass
        with self._lock:
            metrics = list(self._metrics.items())
        return {
            "kind": "registry_snapshot",
            "ts": time.time(),
            "metrics": {
                name: {"kind": m.kind, "help": m.help, "values": m._snapshot_values()}
                for name, m in sorted(metrics)
            },
        }


_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every subsystem publishes into."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the default registry (tests); returns the previous one."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = registry
        return prev
