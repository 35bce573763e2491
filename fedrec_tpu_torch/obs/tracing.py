"""Host spans kept in a bounded in-memory list: the part of
``fedrec_tpu/obs/tracing.py`` the port's serving and training loops call
(its Chrome-trace export is ``ROADMAP.md`` Queue A item 10b)."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator


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


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the default tracer (tests); returns the previous one."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev
