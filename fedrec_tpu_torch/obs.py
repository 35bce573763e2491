"""Minimal telemetry for the port's serving path: counters, gauges,
histograms and host spans, holding only what ``serving.batcher`` and
``serving.server`` call. A small copy of ``fedrec_tpu.obs``'s registry and
tracer surfaces, not an import of them.
"""

from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Sequence

DEFAULT_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)


class _Metric:
    kind = ""

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name, self.help = name, help
        self.label_names = tuple(label_names)
        self._values: dict[tuple, Any] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        return tuple(str(labels.get(k, "")) for k in self.label_names)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, label_names, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        self.buckets = tuple(buckets)

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            cell = self._values.setdefault(
                key, {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "count": 0}
            )
            cell["counts"][bisect.bisect_left(self.buckets, value)] += 1
            cell["sum"] += value
            cell["count"] += 1


class MetricsRegistry:
    """Named instruments plus collectors run before each snapshot."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "", labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)


class Tracer:
    """Host spans kept in a bounded list; ``enabled=False`` records nothing."""

    def __init__(self, capacity: int = 200_000, clock=time.perf_counter):
        self.capacity = capacity
        self.enabled = True
        self._clock = clock
        self._events: list[dict] = []
        self._lock = threading.Lock()

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(ev)

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self._append({"name": name, "dur_s": self._clock() - t0, "args": args})

    def add_span(self, name: str, dur_s: float, **args: Any) -> None:
        if self.enabled:
            self._append({"name": name, "dur_s": float(dur_s), "args": args})


_registry = MetricsRegistry()
_tracer = Tracer()


def get_registry() -> MetricsRegistry:
    return _registry


def get_tracer() -> Tracer:
    return _tracer
