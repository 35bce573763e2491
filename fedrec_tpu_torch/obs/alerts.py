"""Alert lifecycle engine, the port of ``fedrec_tpu/obs/alerts.py``:
pending -> firing -> resolved, one record shape (host only).

* Lifecycle: ``observe(key, breached)`` at evaluation cadence drives each
  keyed alert through pending (``pending_for`` consecutive breached
  evaluations before it fires), firing, and resolved (``resolve_after``
  consecutive healthy evaluations).
* Dedup: a firing alert that keeps breaching emits nothing new; the
  transition is the event, not the state.
* Flap suppression: ``flap_max`` fire cycles within ``flap_window``
  evaluations mute that key's further transition records (counted on
  ``alert.flaps_suppressed_total``).
* Emission: every transition lands in the ``alert.*`` registry
  instruments, a ``{"kind": "alert"}`` JSONL record, a tracer instant and
  any subscribed callbacks (the perf drop capture arms off one).

Nothing here raises out of an emission path: alerting must not take down
the host.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from fedrec_tpu_torch.obs.registry import MetricsRegistry, get_registry

SEVERITIES = ("info", "warning", "critical")

# transition records kept for FleetPusher catch-up slicing; beyond this
# the oldest are dropped and a late pusher simply misses them (the JSONL
# log remains the lossless record)
_RECORD_CAP = 4096


@dataclass
class Alert:
    """One keyed alert's live state."""

    key: str
    severity: str = "warning"
    summary: str = ""
    labels: dict[str, Any] = field(default_factory=dict)
    state: str = "pending"           # pending | firing | resolved
    value: float | None = None
    threshold: float | None = None
    first_breach_unix: float | None = None
    fired_unix: float | None = None
    resolved_unix: float | None = None
    breach_evals: int = 0
    clear_evals: int = 0
    fire_count: int = 0              # times this key fired (dedup counter)
    suppressed: bool = False         # currently flap-suppressed

    def to_dict(self) -> dict[str, Any]:
        return {
            "key": self.key,
            "severity": self.severity,
            "summary": self.summary,
            "labels": dict(self.labels),
            "state": self.state,
            "value": self.value,
            "threshold": self.threshold,
            "first_breach_unix": self.first_breach_unix,
            "fired_unix": self.fired_unix,
            "resolved_unix": self.resolved_unix,
            "fire_count": self.fire_count,
            "suppressed": self.suppressed,
        }


class AlertEngine:
    """The lifecycle state machine + every emission surface.

    ``observe()`` is the only mutation path; :mod:`fedrec_tpu_torch.obs.watch`
    calls it once per (key, evaluation).  Per-call ``pending_for`` /
    ``resolve_after`` overrides let pulse-style triggers (anomaly,
    health outlier) fire on the first breached evaluation while SLO
    breaches keep the configured confirmation count.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        tracer: Any = None,
        *,
        pending_for: int = 2,
        resolve_after: int = 3,
        flap_max: int = 3,
        flap_window: int = 20,
        history: int = 256,
        jsonl_path=None,
        jsonl_max_mb: float = 0.0,
    ):
        self.registry = registry or get_registry()
        if tracer is None:
            from fedrec_tpu_torch.obs.tracing import get_tracer

            tracer = get_tracer()
        self.tracer = tracer
        self.pending_for = max(int(pending_for), 1)
        self.resolve_after = max(int(resolve_after), 1)
        self.flap_max = max(int(flap_max), 0)
        self.flap_window = max(int(flap_window), 1)
        self.jsonl_path = jsonl_path
        self.jsonl_max_mb = float(jsonl_max_mb)
        self._alerts: dict[str, Alert] = {}
        self._history: deque[dict] = deque(maxlen=max(int(history), 1))
        # per-key eval counter + fire-transition eval indices (flap window)
        self._evals: dict[str, int] = {}
        self._fires: dict[str, deque[int]] = {}
        self._subscribers: list[Callable[[Alert, str], None]] = []
        # transition records for the FleetPusher envelope: (offset, list)
        self._records: list[dict] = []
        self._records_offset = 0
        self._c_transitions = self.registry.counter(
            "alert.transitions_total",
            "alert lifecycle transitions performed, labeled by the state "
            "entered (firing/resolved)",
            labels=("state",),
        )
        self._g_firing = self.registry.gauge(
            "alert.firing", "alerts currently in the firing state"
        )
        self._c_flaps = self.registry.counter(
            "alert.flaps_suppressed_total",
            "fire transitions muted by flap suppression (the key exceeded "
            "flap_max fire cycles within flap_window evaluations)",
        )

    # ------------------------------------------------------------ observe
    def observe(
        self,
        key: str,
        breached: bool,
        *,
        severity: str = "warning",
        summary: str = "",
        labels: dict[str, Any] | None = None,
        value: float | None = None,
        threshold: float | None = None,
        pending_for: int | None = None,
        resolve_after: int | None = None,
    ) -> Alert | None:
        """Advance ``key``'s lifecycle with one evaluation's verdict;
        returns the live alert (None once fully inactive)."""
        need_fire = max(int(pending_for or self.pending_for), 1)
        need_clear = max(int(resolve_after or self.resolve_after), 1)
        self._evals[key] = self._evals.get(key, 0) + 1
        a = self._alerts.get(key)
        if breached:
            if a is None or a.state == "resolved":
                a = Alert(key=key)
                self._alerts[key] = a
                a.first_breach_unix = time.time()
            a.severity = severity
            a.summary = summary or a.summary
            a.labels = dict(labels or a.labels)
            a.value = value
            a.threshold = threshold
            a.clear_evals = 0
            a.breach_evals += 1
            if a.state == "pending" and a.breach_evals >= need_fire:
                self._fire(a)
            return a
        if a is None:
            return None
        a.breach_evals = 0
        if a.state == "pending":
            # a pending alert that cleared never fired: silently drop
            del self._alerts[key]
            return None
        if a.state == "firing":
            a.clear_evals += 1
            if a.clear_evals >= need_clear:
                self._resolve(a)
        return a

    # -------------------------------------------------------- transitions
    def _flapping(self, key: str) -> bool:
        if self.flap_max <= 0:
            return False
        now = self._evals.get(key, 0)
        fires = self._fires.setdefault(key, deque())
        while fires and fires[0] <= now - self.flap_window:
            fires.popleft()
        return len(fires) >= self.flap_max

    def _fire(self, a: Alert) -> None:
        a.state = "firing"
        a.fired_unix = time.time()
        a.resolved_unix = None
        a.fire_count += 1
        suppressed = self._flapping(a.key)
        self._fires.setdefault(a.key, deque()).append(self._evals.get(a.key, 0))
        a.suppressed = suppressed
        if suppressed:
            self._c_flaps.inc()
            self._refresh_firing_gauge()
            return
        self._c_transitions.inc(state="firing")
        self._refresh_firing_gauge()
        self._emit(a, "firing")

    def _resolve(self, a: Alert) -> None:
        suppressed = a.suppressed
        a.state = "resolved"
        a.resolved_unix = time.time()
        a.suppressed = False
        self._history.append(a.to_dict())
        del self._alerts[a.key]
        self._refresh_firing_gauge()
        if suppressed:
            return  # a muted fire resolves silently too — no half-pairs
        self._c_transitions.inc(state="resolved")
        self._emit(a, "resolved")

    def _refresh_firing_gauge(self) -> None:
        self._g_firing.set(float(sum(
            1 for x in self._alerts.values() if x.state == "firing"
        )))

    # ----------------------------------------------------------- emission
    def _emit(self, a: Alert, event: str) -> None:
        record = {
            "kind": "alert",
            "event": event,
            "ts": time.time(),
            **{k: v for k, v in a.to_dict().items() if v is not None},
        }
        ctx = self.registry.context
        if ctx.get("worker") is not None and "worker" not in record["labels"]:
            record["labels"]["worker"] = ctx["worker"]
        self._records.append(record)
        if len(self._records) > _RECORD_CAP:
            drop = len(self._records) - _RECORD_CAP
            del self._records[:drop]
            self._records_offset += drop
        if self.jsonl_path is not None:
            try:
                from fedrec_tpu_torch.obs.report import rotate_jsonl

                if self.jsonl_max_mb:
                    rotate_jsonl(self.jsonl_path, self.jsonl_max_mb)
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            except OSError:
                pass  # alerting must not take down the host
        try:
            self.tracer.instant(
                "alert", key=a.key, event=event, severity=a.severity,
                summary=a.summary,
            )
        except Exception:  # noqa: BLE001 — emission is best-effort
            pass
        for fn in list(self._subscribers):
            try:
                fn(a, event)
            except Exception:  # noqa: BLE001 — a bad subscriber must not
                pass           # block the others or the lifecycle

    def subscribe(self, fn: Callable[[Alert, str], None]) -> None:
        """``fn(alert, event)`` runs on every unsuppressed transition —
        the hook the perf drop-capture arms off."""
        if fn not in self._subscribers:
            self._subscribers.append(fn)

    # ----------------------------------------------------------- surfaces
    def active(self) -> list[dict]:
        """Pending + firing alerts, firing first, newest breach first."""
        order = {"firing": 0, "pending": 1}
        return [
            a.to_dict() for a in sorted(
                self._alerts.values(),
                key=lambda x: (order.get(x.state, 2),
                               -(x.first_breach_unix or 0.0)),
            )
        ]

    def firing(self) -> list[dict]:
        return [a.to_dict() for a in self._alerts.values()
                if a.state == "firing"]

    def history(self) -> list[dict]:
        """Resolved alerts, oldest first (bounded by ``history``)."""
        return list(self._history)

    def records_since(self, index: int) -> tuple[list[dict], int]:
        """Transition records appended at/after absolute ``index`` —
        the FleetPusher's catch-up slice; returns (records, next_index)."""
        start = max(index - self._records_offset, 0)
        out = self._records[start:]
        return out, self._records_offset + len(self._records)

    def snapshot_state(self) -> dict:
        """The serving admin ``{"cmd": "alerts"}`` payload shape."""
        return {"active": self.active(), "recent": self.history()}
