"""Host-side span tracer emitting Chrome-trace / Perfetto JSON, a copy of
``fedrec_tpu/obs/tracing.py``.

The profiler answers "what did the DEVICE do"; it says nothing about the
host-side round structure (batch build, dispatch, aggregation, eval) or the
serving request lifecycle. This tracer records those as wall-clock spans
and writes them in the Chrome trace event format (``{"traceEvents":
[...]}``), which ``chrome://tracing`` and https://ui.perfetto.dev load.

Correlating host and device: the trainer wraps every round in both a host
span here and a ``torch.profiler.record_function("fed_round#N")``, so a
CUDA trace captured around it (``obs.perf.capture_rounds``) carries the same
round numbers as the host spans.

* Cheap when idle: a span is a clock read and a list append under a lock;
  no I/O until ``save()``.
* Bounded: at most ``capacity`` events are kept (earliest win); the rest
  count in ``dropped``, stamped into the saved file's ``otherData``.
* Timestamps are monotonic (``time.perf_counter`` from the tracer's epoch,
  in microseconds) and ``save()`` sorts events.

Spans measured on another clock use :meth:`Tracer.add_span` with an
explicit duration; only the end is placed on the tracer clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Iterator


class Tracer:
    """Bounded in-memory recorder of Chrome-trace events."""

    def __init__(self, capacity: int = 200_000, clock=time.perf_counter):
        self.capacity = int(capacity)
        # enabled=False makes every record a no-op that also skips the drop
        # counter — the switch for processes that will never save a trace
        # (e.g. fedrec-serve without --obs-dir), so per-request spans cost
        # neither memory nor lock traffic there
        self.enabled = True
        self._clock = clock
        self._t0 = clock()
        self._epoch_unix = time.time()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0
        self._pid = os.getpid()
        # fleet correlation keys (obs.fleet.set_fleet_identity) merged into
        # every recorded event's args, so traces of several processes join
        self._context: dict[str, Any] = {}

    @property
    def epoch_unix(self) -> float:
        """Wall-clock time at this tracer's epoch: the anchor the fleet
        merger aligns processes by before its finer corrections."""
        return self._epoch_unix

    def set_context(self, **kv: Any) -> None:
        """Replace the label set stamped into every later event's args
        (an event's own args win on a key collision)."""
        self._context = {k: v for k, v in kv.items() if v is not None}

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Seconds on the tracer clock (pair with :meth:`add_span`)."""
        return self._clock()

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    # ----------------------------------------------------------- record
    def _append(self, ev: dict) -> None:
        if not self.enabled:
            return
        if self._context:
            ev["args"] = {**self._context, **ev.get("args", {})}
        with self._lock:
            if len(self._events) >= self.capacity:
                self.dropped += 1
                return
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """Record the enclosed block as one complete ("X") event."""
        if not self.enabled:
            yield
            return
        start = self._clock()
        try:
            yield
        except BaseException as e:
            args = {**args, "error": type(e).__name__}
            raise
        finally:
            end = self._clock()
            self._append({
                "name": name,
                "ph": "X",
                "ts": self._us(start),
                "dur": (end - start) * 1e6,
                "pid": self._pid,
                "tid": threading.get_ident() % 0x7FFFFFFF,
                **({"args": args} if args else {}),
            })

    def add_span(
        self, name: str, dur_s: float, end: float | None = None, **args: Any
    ) -> None:
        """Record a span of known duration ending at ``end`` (tracer-clock
        seconds, default now).  For intervals whose start was stamped on a
        DIFFERENT monotonic clock: only the duration crosses over, so no
        cross-clock timestamp arithmetic can skew the timeline."""
        if not self.enabled:
            return
        end = self._clock() if end is None else end
        dur_s = max(float(dur_s), 0.0)
        self._append({
            "name": name,
            "ph": "X",
            "ts": self._us(end - dur_s),
            "dur": dur_s * 1e6,
            "pid": self._pid,
            "tid": threading.get_ident() % 0x7FFFFFFF,
            **({"args": args} if args else {}),
        })

    def instant(self, name: str, **args: Any) -> None:
        self._append({
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._us(self._clock()),
            "pid": self._pid,
            "tid": threading.get_ident() % 0x7FFFFFFF,
            **({"args": args} if args else {}),
        })

    _FLOW_PH = {"out": "s", "step": "t", "in": "f"}

    def flow(self, direction: str, flow_id: int, name: str = "wire",
             ts: float | None = None, **args: Any) -> None:
        """A Chrome-trace flow event (``ph`` s/t/f): the arrow that links
        spans across processes in the merged fleet trace. ``direction`` is
        "out" (start), "step" or "in" (finish); events sharing ``flow_id``
        (category "wire") form one arrow. ``ts`` (tracer-clock seconds,
        default now) must fall inside the span the arrow binds to."""
        ph = self._FLOW_PH[direction]
        ev = {
            "name": name,
            "cat": "wire",
            "ph": ph,
            "id": int(flow_id),
            "ts": self._us(self._clock() if ts is None else ts),
            "pid": self._pid,
            "tid": threading.get_ident() % 0x7FFFFFFF,
            **({"args": args} if args else {}),
        }
        if ph == "f":
            ev["bp"] = "e"  # bind to the enclosing slice, not the next
        self._append(ev)

    # ------------------------------------------------------------ export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def event_count(self) -> int:
        """How many events are recorded — pair with :meth:`events_since`
        for incremental readers (obs.perf digests only the spans of the
        round that just ended) without copying the whole ring each
        round."""
        with self._lock:
            return len(self._events)

    def events_since(self, start: int) -> list[dict]:
        """The events recorded at index ``start`` onward (a prior
        :meth:`event_count` reading)."""
        with self._lock:
            return list(self._events[start:])

    def to_chrome(self) -> dict:
        """Chrome trace event JSON object; events sorted by ``ts`` so the
        exported timeline is monotonic."""
        evs = sorted(self.events(), key=lambda e: e["ts"])
        return {
            "traceEvents": evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "fedrec_tpu_torch.obs",
                "epoch_unix": self._epoch_unix,
                "dropped_events": self.dropped,
            },
        }

    def save(self, path) -> dict:
        """Write the Perfetto/Chrome-trace JSON; returns what was written."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


# ------------------------------------------------------------- global default
_default_tracer = Tracer()
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide default tracer every subsystem records into."""
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the default tracer (tests); returns the previous one."""
    global _default_tracer
    with _default_lock:
        prev = _default_tracer
        _default_tracer = tracer
        return prev
