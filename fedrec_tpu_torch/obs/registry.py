"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``fedrec_tpu/obs/registry.py`` (the port imports nothing of the
JAX package) with its fleet labels (``set_context``: the ``"fleet"`` key of
every snapshot and of every ``MetricLogger`` record, stamped by
``obs.fleet.set_fleet_identity``), its Prometheus text exposition
(``snapshot_to_prometheus``: ``prometheus.txt``, the ``prometheus`` admin
command and ``fedrec-obs prom``) and its JSONL snapshot writer.

* Names are dotted (``serve.p50_ms``, ``health.grad_norm``); the
  exposition sanitizes them (``serve_p50_ms``) and keeps the dotted
  original in the ``# HELP`` line.
* Get-or-create is idempotent: ``registry.counter("x")`` from two modules
  returns the same instrument; re-registering a name as another kind, with
  other label names or other buckets raises.
* Histograms use fixed upper-bound buckets with Prometheus ``le``
  semantics (inclusive); ``merge_counts`` adds a whole array's bucket
  counts under one lock (``obs.health`` publishes a round's cells at once).
* Collectors run just before a snapshot, to refresh derived gauges.
* ``quantile_from_counts`` is the one percentile estimator of a
  histogram's buckets (``obs.report``).

``get_registry`` is the process's default registry; tests swap in a fresh
one with ``set_registry``.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Mapping, Sequence

# default latency-flavoured buckets (ms); callers pass their own for other units
DEFAULT_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0
)

_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_prom_name(name: str) -> str:
    """Dotted internal name -> valid Prometheus metric name."""
    out = _PROM_NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


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
        # fleet correlation keys (obs.fleet.set_fleet_identity): the
        # snapshots' "fleet" key, merged into every MetricLogger record
        self._context: dict[str, Any] = {}

    def set_context(self, **kv: Any) -> None:
        """Replace the fleet label set carried by subsequent snapshots."""
        with self._lock:
            self._context = {k: v for k, v in kv.items() if v is not None}

    @property
    def context(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._context)

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
            context = dict(self._context)
        return {
            "kind": "registry_snapshot",
            "ts": time.time(),
            **({"fleet": context} if context else {}),
            "metrics": {
                name: {"kind": m.kind, "help": m.help, "values": m._snapshot_values()}
                for name, m in sorted(metrics)
            },
        }

    def write_snapshot(self, path) -> dict:
        """Append one snapshot line to a JSONL event log; returns the snapshot."""
        snap = self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")
            f.flush()
        return snap

    # -------------------------------------------------------- prometheus
    def to_prometheus(self) -> str:
        """Text exposition format (version 0.0.4) — the shared
        :func:`snapshot_to_prometheus` over a fresh snapshot, so the live
        endpoint and the offline ``fedrec-obs prom`` twin can never
        drift."""
        return snapshot_to_prometheus(self.snapshot())


def _fmt_labels(labels: Mapping[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_prom_name(str(k))}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    f = float(v)
    if not math.isfinite(f):  # the text format's spellings (a run that went NaN)
        return "NaN" if f != f else ("+Inf" if f > 0 else "-Inf")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def quantile_from_counts(
    q: float, bounds: Sequence[float], counts: Sequence[float]
) -> float | None:
    """Linear-interpolation quantile over histogram buckets.

    ``bounds``: ascending finite upper bounds; ``counts``: per-bucket
    counts with the +Inf bucket LAST (``len(counts) == len(bounds) + 1``).
    ``obs.report.histogram_quantile`` runs it over an exported row.
    """
    total = sum(counts)
    if total == 0 or not bounds:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):
                return bounds[-1]  # +Inf bucket: clamp to the last finite bound
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (rank - prev) / c
            return lo + (bounds[i] - lo) * min(max(frac, 0.0), 1.0)
    return bounds[-1]


def snapshot_to_prometheus(snap: dict) -> str:
    """Render an (exported or live) registry snapshot dict as Prometheus
    text.  Dotted internal names are sanitized; the HELP line carries the
    dotted original so both spellings are greppable.  The one renderer:
    ``MetricsRegistry.to_prometheus`` and ``fedrec-obs prom`` both call it."""
    lines: list[str] = []
    for name, m in sorted(snap.get("metrics", {}).items()):
        pname = sanitize_prom_name(name)
        help_text = name + (f" — {m['help']}" if m.get("help") else "")
        lines.append(f"# HELP {pname} {help_text}")
        lines.append(f"# TYPE {pname} {m.get('kind', 'untyped')}")
        for row in m.get("values", []):
            labels = row.get("labels", {})
            label_str = _fmt_labels(labels)
            if "buckets" in row:
                cum = 0
                for le, n in row["buckets"].items():
                    cum += n
                    le_val = le if le == "+Inf" else repr(float(le))
                    bl = _fmt_labels({**labels, "le": le_val})
                    lines.append(f"{pname}_bucket{bl} {cum}")
                lines.append(f"{pname}_sum{label_str} {_fmt_num(row['sum'])}")
                lines.append(f"{pname}_count{label_str} {int(row['count'])}")
            else:
                lines.append(f"{pname}{label_str} {_fmt_num(row['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")



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
