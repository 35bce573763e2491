"""Fleet-wide observability, the port of ``fedrec_tpu/obs/fleet.py``:
correlation keys, the telemetry collector, the merged distributed trace and
straggler attribution. Host only: it imports no torch, so a collector or a
merge starts in an interpreter's time on any box the artifacts were copied
to, and either package's merger reads either's artifacts.

* Correlation keys: :func:`set_fleet_identity` stamps ``worker`` /
  ``rank`` / ``membership_epoch`` into every span's args (the tracer's
  context), every registry snapshot (its ``"fleet"`` key) and every
  ``MetricLogger`` record.
* Round-cadence collection: :class:`TelemetryCollector` (standalone behind
  :class:`CollectorServer`, ``python -m fedrec_tpu_torch.obs.fleet
  HOST:PORT --dir D``, or on the membership service's port with
  ``--telemetry-dir D``) takes ``telemetry_push`` lines from
  :class:`FleetPusher` workers (a registry snapshot and the spans since the
  last push) and writes them in the ``worker_*`` layout the offline merge
  reads, so a run without a collector loses nothing.
* The one JSON-lines exchange of the control plane: :func:`serve_json_line`
  and :func:`request_json_line`, with the ``obs.wire`` envelope; the
  membership service, the commit authority, ``parallel.rpc.FleetRpc`` and
  the collector all speak it.
* The merged trace: :func:`build_fleet_trace`, one Perfetto document with
  a track per worker; clocks aligned by each tracer's ``epoch_unix``, then
  by the shared ``fed_round`` barriers (:func:`estimate_clock_offsets`),
  then, for processes that share no round, by the wire's per-edge offsets.
* Attribution: :func:`attribute_critical_path` names each round's gating
  worker and its marginal ``gate_ms``; :func:`build_fleet_report` adds the
  membership timeline, DCN bytes, the Aggregation, Wire and Alerts panels.
* Counter continuity: :func:`save_counter_baseline` /
  :func:`restore_counter_baseline` carry a worker's counter totals across
  a respawn.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from fedrec_tpu_torch.obs.registry import get_registry
from fedrec_tpu_torch.obs.tracing import get_tracer

# the round-work phases attribution breaks a gating round down into (the one
# home of the names: obs.perf's phase table imports them from here)
ROUND_PHASES = ("batch_build", "h2d", "dispatch", "aggregate", "eval")

# ------------------------------------------------------------------ identity
_identity_lock = threading.Lock()
_identity: dict[str, Any] = {}


def set_fleet_identity(
    worker: str,
    rank: int | None = None,
    epoch: int | None = None,
    registry=None,
    tracer=None,
) -> dict[str, Any]:
    """Stamp this process's fleet correlation keys everywhere at once:
    the tracer context (merged into every span's args), the registry
    context (the ``"fleet"`` key of every snapshot, which MetricLogger
    also merges into its JSONL records).  ``epoch`` is the membership
    epoch (omit for fixed worlds).  Returns the identity dict."""
    global _identity
    ident: dict[str, Any] = {"worker": str(worker)}
    if rank is not None:
        ident["rank"] = int(rank)
    if epoch is not None:
        ident["membership_epoch"] = int(epoch)
    with _identity_lock:
        _identity = ident
    (tracer or get_tracer()).set_context(**ident)
    (registry or get_registry()).set_context(**ident)
    return dict(ident)


def ensure_fleet_identity(worker: str = "0", rank: int | None = None) -> dict:
    """Set the identity only when no earlier caller (the coordinator CLI,
    which knows the stable worker id and membership epoch) already did —
    the Trainer's constructor hook for fixed-world/single-process runs."""
    with _identity_lock:
        if _identity:
            return dict(_identity)
    return set_fleet_identity(worker, rank=rank)


def get_fleet_identity() -> dict[str, Any]:
    with _identity_lock:
        return dict(_identity)


def reset_fleet_identity() -> None:
    """Clear the process identity (tests)."""
    global _identity
    with _identity_lock:
        _identity = {}


# ---------------------------------------------------------------- collector
_WORKER_ID_BAD = re.compile(r"[^A-Za-z0-9_.-]")


def _safe_worker_id(worker: str) -> str:
    return _WORKER_ID_BAD.sub("_", str(worker)) or "unknown"


class TelemetryCollector:
    """The fleet's round-cadence telemetry sink.

    ``handle(request)`` consumes one ``telemetry_push`` dict (a registry
    snapshot + the spans completed since the worker's last push) and
    appends it to ``<dir>/worker_<id>/metrics.jsonl`` — snapshots as
    ordinary ``registry_snapshot`` lines, spans as ``trace_events``
    lines keyed by the pushing incarnation's ``epoch_unix`` clock
    anchor.  That is deliberately the SAME layout the offline
    ``worker_*`` fallback reads (:func:`load_fleet_dir`), so a collector
    dir and a post-hoc merge of the workers' own obs dirs render through
    identical code paths.

    Transport-agnostic: :class:`CollectorServer` wraps it standalone;
    ``MembershipServer(collector=...)`` routes the same commands over the
    membership port (one control-plane address per federation).

    Each worker's log is size-rotated (``jsonl_max_mb``, one ``.1`` level
    — the same bound the Trainer's ``obs.jsonl_max_mb`` applies), so a
    long-lived federation pushing every round cannot grow the collector
    dir without bound.
    """

    def __init__(self, directory, jsonl_max_mb: float = 256.0):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.jsonl_max_mb = float(jsonl_max_mb)
        self._lock = threading.Lock()
        self.pushes = 0
        self.workers: dict[str, dict] = {}
        # fleet-level watch rules (obs.watch.FleetRules),
        # evaluated per push when attached; their alert records land in
        # worker_fleet/metrics.jsonl through the rules' own engine
        self.rules = None

    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "telemetry_push":
            return self._push(req)
        if cmd == "telemetry_status":
            return self.status()
        return {"error": f"unknown telemetry cmd {cmd!r}"}

    def _push(self, req: dict) -> dict:
        worker = req.get("worker")
        if worker is None:
            return {"error": "telemetry_push requires a worker id"}
        wid = _safe_worker_id(worker)
        fleet = {
            k: req[k]
            for k in ("worker", "rank", "membership_epoch")
            if req.get(k) is not None
        }
        lines: list[str] = []
        snap = req.get("snapshot")
        if isinstance(snap, dict):
            if fleet and "fleet" not in snap:
                snap = {**snap, "fleet": fleet}
            lines.append(json.dumps(snap))
        events = req.get("events")
        if events:
            lines.append(json.dumps({
                "kind": "trace_events",
                "epoch_unix": float(req.get("epoch_unix") or 0.0),
                "fleet": fleet,
                "events": events,
            }))
        # alert transition records ride the same envelope; written into
        # the worker's log verbatim so fedrec-obs alerts/tail/fleet read
        # them from a collector dir exactly as from an offline obs dir
        for rec in req.get("alerts") or ():
            if isinstance(rec, dict):
                lines.append(json.dumps(rec))
        with self._lock:
            wdir = self.directory / f"worker_{wid}"
            wdir.mkdir(parents=True, exist_ok=True)
            if lines:
                from fedrec_tpu_torch.obs.report import rotate_jsonl

                rotate_jsonl(wdir / "metrics.jsonl", self.jsonl_max_mb)
                with open(wdir / "metrics.jsonl", "a") as f:
                    f.write("\n".join(lines) + "\n")
            self.pushes += 1
            w = self.workers.setdefault(
                wid, {"pushes": 0, "events": 0, "first_push": time.time()}
            )
            w["pushes"] += 1
            w["events"] += len(events or ())
            w["last_push"] = time.time()
            for k, v in fleet.items():
                w[k] = v
        if self.rules is not None:
            try:
                self.rules.observe_push(wid, snap)
            except Exception:  # noqa: BLE001 — a rule bug must not
                pass           # break telemetry ingestion
        return {"ok": True, "worker": wid}

    def status(self) -> dict:
        with self._lock:
            return {
                "dir": str(self.directory),
                "pushes": self.pushes,
                "workers": {k: dict(v) for k, v in self.workers.items()},
            }


def request_json_line(
    host: str, port: int, req: dict, timeout_s: float, op: str | None = None,
    connect_timeout_s: float | None = None,
) -> dict:
    """THE client half of the one-shot JSON-lines exchange: connect,
    send one request line, read one response line.  Raises ``OSError``
    on transport failure (a hang-up with no response line included — an
    ack-less close is NOT a response) and ``ValueError`` on a malformed
    or ``{"error": ...}`` reply.  Shared by :class:`FleetPusher`,
    ``MembershipClient`` and the async agg worker so the client wire
    protocol cannot drift.

    ``connect_timeout_s`` splits the dial deadline from the exchange
    deadline (``timeout_s``): a dead host should fail in connect time,
    while a live peer mid-fold gets the full read budget.  ``None``
    keeps the historical single-deadline behavior.

    Wire observability (:mod:`fedrec_tpu_torch.obs.wire`, default on): the
    request carries an additive trace-context envelope, the reply's
    envelope (if the peer echoes one) is stripped off before return and
    feeds the per-edge RTT/offset telemetry — callers see the exact
    pre-envelope response surface either way.  ``op`` labels the edge
    (defaults to the request's ``cmd``)."""
    from fedrec_tpu_torch.obs import wire

    req_env = None
    if wire.wire_enabled():
        op = op or str(req.get("cmd", "req"))
        req_env = wire.request_envelope(op)
        req = {**req, wire.WIRE_KEY: req_env}
    line = (json.dumps(req) + "\n").encode()
    t0 = time.perf_counter()
    dial_s = timeout_s if connect_timeout_s is None else connect_timeout_s
    try:
        with socket.create_connection((host, port), timeout=dial_s) as conn:
            conn.settimeout(timeout_s)
            conn.sendall(line)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
        if not buf:
            raise OSError("empty response (connection closed before a reply)")
        if b"\n" not in buf:
            # a hang-up mid-reply (a peer killed while it streamed a large
            # reply): the line never ended, so it is a transport failure the
            # caller may retry, not a malformed answer
            raise OSError(f"connection closed mid-reply ({len(buf)} bytes, no line end)")
        resp = json.loads(buf.split(b"\n", 1)[0].decode())
        if isinstance(resp, dict) and resp.get("error"):
            raise ValueError(str(resp["error"]))
    except (OSError, ValueError):
        if req_env is not None:
            wire.record_client_error(host, port, str(op))
        raise
    ack_ts = time.time()
    resp, resp_env = wire.unwrap_envelope(resp)
    if req_env is not None:
        wire._set_last_reply(resp_env)
        wire.record_client_exchange(
            host, port, str(op), req_env, resp_env,
            bytes_sent=len(line), bytes_recvd=len(buf),
            rtt_s=time.perf_counter() - t0, ack_ts=ack_ts,
        )
    return resp


def serve_json_line(
    conn: socket.socket,
    handler,
    timeout_s: float = 30.0,
    recv_bytes: int = 1 << 20,
) -> None:
    """THE one-request JSON-lines exchange: read one request line, answer
    ``handler(request)`` as one response line.  A torn or malformed
    connection answers ``{"error": "bad request"}`` where possible and
    never raises — shared by :class:`CollectorServer`, the membership
    service and the async commit authority so the wire protocol cannot
    drift between servers.

    Wire observability (:mod:`fedrec_tpu_torch.obs.wire`): an incoming
    trace-context envelope is stripped BEFORE ``handler`` sees the
    request (unknown envelope keys never leak into op dispatch) and a
    reply envelope is echoed ONLY when the request carried one — a
    client that predates the envelope gets byte-identical pre-envelope
    replies."""
    from fedrec_tpu_torch.obs import wire

    with conn:
        try:
            conn.settimeout(timeout_s)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(recv_bytes)
                if not chunk:
                    return  # hung up before a full request line: no reply
                buf += chunk
            req_line = buf.split(b"\n", 1)[0]
            recv_ts = time.time()
            req = json.loads(req_line.decode())
            env = None
            if isinstance(req, dict):
                req, env = wire.unwrap_envelope(req)
            if env is None:
                resp = handler(req)
                conn.sendall((json.dumps(resp) + "\n").encode())
                return
            token = wire.enter_serve(env, recv_ts)
            try:
                resp = handler(req)
                reply_env = wire.server_reply_envelope(env, recv_ts)
            finally:
                wire.exit_serve(token)
            if isinstance(resp, dict):
                resp = {**resp, wire.WIRE_KEY: reply_env}
            out = (json.dumps(resp) + "\n").encode()
            conn.sendall(out)
            wire.record_server_exchange(
                env, reply_env, op=str(env.get("op") or "req"),
                bytes_recvd=len(req_line) + 1, bytes_sent=len(out),
            )
        except (OSError, ValueError, KeyError):
            try:
                conn.sendall(b'{"error": "bad request"}\n')
            except OSError:
                pass


class CollectorServer:
    """Standalone TCP JSON-lines front for a :class:`TelemetryCollector`
    (the same wire idiom as the membership service and serving admin
    channel: one request line in, one response line out), serving each
    connection through :func:`serve_json_line`."""

    def __init__(self, collector: TelemetryCollector,
                 host: str = "127.0.0.1", port: int = 0):
        self.collector = collector
        self.host = host
        self.port = port
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "CollectorServer":
        srv = socket.create_server((self.host, self.port))
        srv.settimeout(0.5)
        self._srv = srv
        self.port = srv.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        assert self._srv is not None
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=serve_json_line, args=(conn, self.collector.handle),
                daemon=True,
            ).start()


class FleetPusher:
    """One worker's push side of the collector protocol.

    ``push()`` ships the current registry snapshot plus the trace events
    recorded since the previous push (disjoint slices — the collector
    never sees a span twice) over a fresh TCP connection.  Failures are
    COUNTED (``obs.fleet_push_failures_total``), never raised: telemetry
    must not take down training, and the offline ``worker_*`` artifacts
    remain the lossless fallback.  After ``_BACKOFF_AFTER`` consecutive
    failures, round-cadence pushes are SKIPPED for an exponentially
    growing window (a packet-dropping collector would otherwise stall
    every round by the full connect timeout); ``final=True`` pushes
    always try — they are once-per-run and bounded — and get one
    bounded retry, since a single transient failure there would lose
    the last round's telemetry outright.  Identity
    (worker/rank/epoch) is read from :func:`get_fleet_identity` at push
    time unless given."""

    _BACKOFF_AFTER = 3          # consecutive failures before skipping
    _BACKOFF_BASE_S = 30.0
    _BACKOFF_MAX_S = 600.0
    _FINAL_RETRY_DELAY_S = 1.0  # the final push's single bounded retry

    def __init__(
        self,
        address: str,
        worker: str | None = None,
        registry=None,
        tracer=None,
        timeout_s: float = 5.0,
        push_every: int = 1,
    ):
        host, port = str(address).rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.worker = worker
        self.timeout_s = float(timeout_s)
        self.push_every = max(int(push_every), 1)
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        self._sent_events = 0
        # alert engine whose transition records ride the push envelope
        # (set by the Trainer when the watch layer is live); the same
        # disjoint-slice contract as trace events
        self.engine = None
        self._sent_alerts = 0
        self.failures = 0
        self._consec_failures = 0
        self._backoff_until = 0.0
        self._m_pushes = self.registry.counter(
            "obs.fleet_pushes_total",
            "telemetry pushes delivered to the fleet collector",
        )
        self._m_failures = self.registry.counter(
            "obs.fleet_push_failures_total",
            "telemetry pushes that failed (unreachable/torn collector); "
            "the offline worker_* artifacts remain the lossless fallback",
        )

    def maybe_push(self, round_idx: int) -> bool | None:
        """Round-cadence hook: push when ``round_idx`` completes a
        ``push_every`` stride; None when off-cadence."""
        if (round_idx + 1) % self.push_every != 0:
            return None
        return self.push()

    def push(self, final: bool = False) -> bool:
        if not final and time.monotonic() < self._backoff_until:
            return False  # backing off a dead collector: skip, don't stall
        ident = get_fleet_identity()
        worker = self.worker if self.worker is not None else ident.get("worker", "0")
        events = self.tracer.events()
        new = events[self._sent_events:]
        alerts: list = []
        next_alert_idx = self._sent_alerts
        if self.engine is not None:
            alerts, next_alert_idx = self.engine.records_since(
                self._sent_alerts
            )
        req = {
            "cmd": "telemetry_push",
            "worker": str(worker),
            "rank": ident.get("rank"),
            "membership_epoch": ident.get("membership_epoch"),
            "epoch_unix": self.tracer.epoch_unix,
            "snapshot": self.registry.snapshot(),
            "events": new,
            "alerts": alerts,
            "final": bool(final),
        }
        # a FINAL push is once-per-run — its failure loses the last
        # round's telemetry outright, so it gets one bounded retry where
        # round-cadence pushes (a later round will re-carry the snapshot)
        # stay single-attempt
        attempts = 2 if final else 1
        delivered = False
        for attempt in range(attempts):
            try:
                request_json_line(self.host, self.port, req, self.timeout_s)
                delivered = True
                break
            except (OSError, ValueError):
                self.failures += 1
                self._consec_failures += 1
                self._m_failures.inc()
                if attempt + 1 < attempts:
                    time.sleep(self._FINAL_RETRY_DELAY_S)
        if not delivered:
            if self._consec_failures >= self._BACKOFF_AFTER:
                delay = min(
                    self._BACKOFF_BASE_S
                    * 2 ** (self._consec_failures - self._BACKOFF_AFTER),
                    self._BACKOFF_MAX_S,
                )
                self._backoff_until = time.monotonic() + delay
            return False
        # only advance past events the collector acknowledged
        self._sent_events += len(new)
        self._sent_alerts = next_alert_idx
        self._consec_failures = 0
        self._backoff_until = 0.0
        self._m_pushes.inc()
        return True


# ---------------------------------------------------------- counter baselines
COUNTER_BASELINE_FILE = "counters.json"


def counter_baseline(registry=None) -> dict:
    """Every counter's current cells as a JSON-serializable baseline —
    what a respawned incarnation of this worker re-seeds its registry
    with so totals resume instead of resetting."""
    registry = registry or get_registry()
    snap = registry.snapshot()
    counters: dict[str, Any] = {}
    for name, m in snap.get("metrics", {}).items():
        if m.get("kind") != "counter":
            continue
        cells = [
            {"labels": row.get("labels", {}), "value": row["value"]}
            for row in m.get("values", [])
            if row.get("value")
        ]
        if cells:
            counters[name] = {
                "help": m.get("help", ""),
                # label NAMES in declaration order (a snapshot row's label
                # dict preserves it, and so does JSON) — restore must
                # re-register with the exact order or the registry's
                # label-tuple identity check rejects the production
                # registration that follows
                "labels": list(cells[0]["labels"]),
                "cells": cells,
            }
    return counters


def save_counter_baseline(obs_dir, registry=None, epoch: int | None = None) -> Path:
    """Persist the worker's counter totals (epoch-tagged) in its obs dir
    (``counters.json``); :func:`restore_counter_baseline` re-seeds a
    respawned incarnation from it."""
    out = Path(obs_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / COUNTER_BASELINE_FILE
    doc = {
        "kind": "counter_baseline",
        "ts": time.time(),
        "epoch": epoch,
        "counters": counter_baseline(registry),
    }
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc))
    tmp.replace(path)
    return path


def restore_counter_baseline(obs_dir, registry=None) -> int | None:
    """Re-seed the registry's counters from a previously saved baseline;
    returns the baseline's membership epoch tag (None when absent or no
    baseline exists).  Kind conflicts and torn files are skipped, not
    fatal — a lost baseline only costs continuity, never the run."""
    path = Path(obs_dir) / COUNTER_BASELINE_FILE
    if not path.exists():
        return None
    registry = registry or get_registry()
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if doc.get("kind") != "counter_baseline":
        return None
    for name, m in doc.get("counters", {}).items():
        for cell in m.get("cells", ()):
            labels = cell.get("labels", {})
            # declaration-order label names: explicit when the baseline
            # recorded them, else the cell dict's own (JSON-preserved)
            # key order — NEVER sorted, which would collide with the
            # registry's order-sensitive re-registration check
            names = tuple(m.get("labels") or labels)
            try:
                registry.counter(
                    name, m.get("help", ""), labels=names
                ).inc(float(cell["value"]), **labels)
            except (ValueError, KeyError, TypeError):
                continue  # kind/label conflict or torn cell: skip it
    epoch = doc.get("epoch")
    return int(epoch) if epoch is not None else None


# ----------------------------------------------------------------- loading
@dataclass
class WorkerTrace:
    """One incarnation's worth of trace events with its wall-clock anchor."""

    epoch_unix: float
    events: list[dict] = field(default_factory=list)
    tag: str = ""


@dataclass
class WorkerData:
    """Everything the fleet layer knows about one worker."""

    worker: str
    snapshots: list[dict] = field(default_factory=list)
    records: list[dict] = field(default_factory=list)
    traces: list[WorkerTrace] = field(default_factory=list)
    path: str = ""

    def last_snapshot(self) -> dict | None:
        return self.snapshots[-1] if self.snapshots else None


def load_worker_dir(path, worker: str | None = None) -> WorkerData:
    """One worker's artifacts — an obs trio dir (trace.json +
    epoch-tagged trace_e*.json siblings) and/or a collector-written dir
    (``trace_events`` lines inside metrics.jsonl)."""
    from fedrec_tpu_torch.obs.report import load_jsonl, load_trace

    p = Path(path)
    wid = worker if worker is not None else p.name.removeprefix("worker_")
    data = WorkerData(worker=str(wid), path=str(p))
    metrics = p / "metrics.jsonl"
    if metrics.exists() or Path(str(metrics) + ".1").exists():
        try:
            records, snapshots = load_jsonl(metrics)
        except (OSError, FileNotFoundError):
            records, snapshots = [], []
        data.snapshots = snapshots
        pushed: dict[float, WorkerTrace] = {}
        for r in records:
            if r.get("kind") == "trace_events":
                anchor = float(r.get("epoch_unix") or 0.0)
                tr = pushed.setdefault(
                    anchor, WorkerTrace(epoch_unix=anchor, tag="pushed")
                )
                tr.events.extend(
                    e for e in r.get("events", ()) if isinstance(e, dict)
                )
            else:
                data.records.append(r)
        data.traces.extend(pushed[k] for k in sorted(pushed))
    # epoch-tagged incarnation traces win over the latest-incarnation
    # trace.json (which duplicates the newest tagged file when both exist)
    tagged = sorted(p.glob("trace_*.json"))
    for f in tagged:
        tr = _load_trace_file(f, load_trace)
        if tr is not None:
            tr.tag = f.stem.removeprefix("trace_")
            data.traces.append(tr)
    if not tagged and (p / "trace.json").exists():
        tr = _load_trace_file(p / "trace.json", load_trace)
        if tr is not None:
            data.traces.append(tr)
    return data


def _load_trace_file(path, load_trace) -> WorkerTrace | None:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(doc, dict):
        events = [e for e in doc.get("traceEvents", ()) if isinstance(e, dict)]
        anchor = float(doc.get("otherData", {}).get("epoch_unix") or 0.0)
    else:
        events = [e for e in doc if isinstance(e, dict)]
        anchor = 0.0
    return WorkerTrace(epoch_unix=anchor, events=events)


def load_fleet_dir(path) -> dict[str, WorkerData]:
    """Discover the fleet under ``path``: a directory of ``worker_*``
    subdirs (the elastic layout AND the collector layout — identical on
    purpose), or a single obs trio dir (treated as worker "0", so the
    fleet commands degrade gracefully to one process).  Raises
    FileNotFoundError with an operator-grade message otherwise."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no such directory: {p}")
    subdirs = sorted(d for d in p.glob("worker_*") if d.is_dir())
    if subdirs:
        workers = {}
        for d in subdirs:
            w = load_worker_dir(d)
            workers[w.worker] = w
        return workers
    if (p / "metrics.jsonl").exists() or (p / "trace.json").exists():
        w = load_worker_dir(p, worker="0")
        return {w.worker: w}
    raise FileNotFoundError(
        f"{p} holds neither worker_* subdirs nor an obs artifact trio — "
        "point at the shared obs.dir of an elastic run, a collector "
        "--telemetry-dir, or one worker's obs dir"
    )


# ---------------------------------------------------------- clock alignment
def _fed_round_starts(trace: WorkerTrace) -> dict[int, float]:
    """round -> wall-clock start of the ``fed_round`` span anchored at it
    (chunked spans anchor at their first round)."""
    out: dict[int, float] = {}
    for e in trace.events:
        if e.get("name") != "fed_round" or e.get("ph") != "X":
            continue
        args = e.get("args", {})
        r = args.get("step_num")
        if r is None:
            continue
        wall = trace.epoch_unix + float(e.get("ts", 0.0)) / 1e6
        out.setdefault(int(r), wall)
    return out


def wire_edge_offsets(
    workers: dict[str, WorkerData],
) -> dict[str, dict[str, float]]:
    """Per-worker wire-measured clock offsets (seconds) toward each peer
    it exchanged enveloped requests with: ``{worker: {peer: offset_s}}``
    where ``offset_s`` is the PEER's clock minus the worker's — the
    windowed NTP-style estimate :mod:`fedrec_tpu_torch.obs.wire` publishes as
    ``wire.clock_offset_ms{peer}``, read back from the last snapshot."""
    from fedrec_tpu_torch.obs.report import _metric_values

    out: dict[str, dict[str, float]] = {}
    for wid, w in workers.items():
        snap = w.last_snapshot()
        if snap is None:
            continue
        edges: dict[str, float] = {}
        for row in _metric_values(snap, "wire.clock_offset_ms"):
            peer = (row.get("labels") or {}).get("peer")
            if peer is not None and "value" in row:
                edges[str(peer)] = float(row["value"]) / 1e3
        if edges:
            out[wid] = edges
    return out


def estimate_clock_offsets(
    workers: dict[str, WorkerData],
) -> dict[tuple[str, int], float]:
    """Per-(worker, incarnation) clock correction in seconds, to ADD to
    that incarnation's wall clock.

    Two alignment sources, in precedence order:

    1. **Round barrier** — every worker's ``fed_round`` N begins at the
       same barrier collective (the round-counter broadcast all members
       block on), so for each incarnation the MEDIAN of (reference
       start - this start) over shared rounds estimates its offset
       against the reference incarnation — the one with the most
       ``fed_round`` spans (stable tie-break by worker id).  Barrier
       alignment always wins where shared rounds exist.
    2. **Wire edges** — an incarnation sharing NO round with the
       reference (the async commit authority, the membership service, a
       worker that died pre-round) resolves through the NTP-style
       per-edge offsets :mod:`fedrec_tpu_torch.obs.wire` measured
       (:func:`wire_edge_offsets`): a worker that measured its offset to
       an aligned hub adopts ``hub_correction + offset``, and a hub that
       only ever ANSWERED requests is placed at the median of
       ``client_correction - client_offset`` over its aligned clients.
       The graph is walked to a fixpoint, so a chain of edges aligns
       too.  Only incarnations the wire cannot reach keep correction 0
       (the raw ``epoch_unix`` wall anchor, the honest fallback)."""
    rounds_by: dict[tuple[str, int], dict[int, float]] = {}
    for wid, w in workers.items():
        for i, tr in enumerate(w.traces):
            rounds_by[(wid, i)] = _fed_round_starts(tr)
    ref_key = None
    for key in sorted(rounds_by):
        if ref_key is None or len(rounds_by[key]) > len(rounds_by[ref_key]):
            ref_key = key
    offsets: dict[tuple[str, int], float] = {}
    unaligned: set[tuple[str, int]] = set()
    ref_rounds = rounds_by.get(ref_key, {}) if ref_key is not None else {}
    for key, mine in rounds_by.items():
        shared = sorted(set(mine) & set(ref_rounds))
        if not shared or key == ref_key:
            offsets[key] = 0.0
            if key != ref_key:
                unaligned.add(key)
            continue
        deltas = sorted(ref_rounds[r] - mine[r] for r in shared)
        offsets[key] = deltas[len(deltas) // 2]  # median
    if not unaligned:
        return offsets
    edges = wire_edge_offsets(workers)
    if not edges:
        return offsets
    # worker-level corrections from barrier-aligned incarnations (the
    # incarnation with the most fed_round spans speaks for the worker)
    aligned: dict[str, float] = {}
    spans_of: dict[str, int] = {}
    for key, off in offsets.items():
        if key in unaligned:
            continue
        wid, _ = key
        n = len(rounds_by.get(key, {}))
        if wid not in aligned or n >= spans_of[wid]:
            aligned[wid] = off
            spans_of[wid] = n
    pending = {wid for wid, _ in unaligned if wid not in aligned}
    for _ in range(len(pending) + 1):
        placed: dict[str, float] = {}
        for wid in sorted(pending):
            cands = [
                aligned[p] + o
                for p, o in edges.get(wid, {}).items()
                if p in aligned
            ]
            cands += [
                aligned[c] - o
                for c, ce in edges.items()
                if c in aligned
                for p, o in ce.items()
                if p == wid
            ]
            if cands:
                cands.sort()
                placed[wid] = cands[len(cands) // 2]
        if not placed:
            break
        aligned.update(placed)
        pending -= set(placed)
    for key in unaligned:
        wid, _ = key
        if wid in aligned:
            offsets[key] = aligned[wid]
    return offsets


# ------------------------------------------------------------- merged trace
def build_fleet_trace(workers: dict[str, WorkerData]) -> dict:
    """ONE Chrome/Perfetto document over every worker's events: a track
    (pid) per worker with a ``process_name`` metadata header, timestamps
    re-based onto the fleet-aligned wall clock (coarse ``epoch_unix`` +
    the round-barrier offset refinement), membership/chaos instants
    riding along unchanged."""
    offsets = estimate_clock_offsets(workers)
    order = sorted(workers)
    pid_of = {wid: i + 1 for i, wid in enumerate(order)}
    aligned: list[tuple[float, dict]] = []
    t0: float | None = None
    for wid in order:
        w = workers[wid]
        for i, tr in enumerate(w.traces):
            corr = offsets.get((wid, i), 0.0)
            for e in tr.events:
                wall = tr.epoch_unix + float(e.get("ts", 0.0)) / 1e6 + corr
                if t0 is None or wall < t0:
                    t0 = wall
                ev = dict(e)
                ev["pid"] = pid_of[wid]
                args = dict(ev.get("args", {}))
                args.setdefault("worker", wid)
                if tr.tag:
                    args.setdefault("incarnation", tr.tag)
                ev["args"] = args
                aligned.append((wall, ev))
    t0 = t0 or 0.0
    events: list[dict] = []
    for wid in order:
        snap = workers[wid].last_snapshot() or {}
        fleet = snap.get("fleet", {})
        label = f"worker {wid}"
        if fleet.get("rank") is not None:
            label += f" (rank {fleet['rank']})"
        events.append({
            "name": "process_name", "ph": "M", "pid": pid_of[wid],
            "args": {"name": label},
        })
        events.append({
            "name": "process_sort_index", "ph": "M", "pid": pid_of[wid],
            "args": {"sort_index": pid_of[wid]},
        })
    for wall, ev in sorted(aligned, key=lambda p: p[0]):
        ev["ts"] = (wall - t0) * 1e6
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "fedrec_tpu_torch.obs.fleet",
            "epoch_unix": t0,
            "workers": {wid: pid_of[wid] for wid in order},
            "clock_offsets_s": {
                f"{wid}/{i}": round(off, 6)
                for (wid, i), off in sorted(offsets.items())
            },
        },
    }


# ------------------------------------------------- critical-path attribution
def _round_intervals(
    tr: WorkerTrace, corr: float
) -> list[tuple[int, float, float, dict[str, float]]]:
    """(round, aligned start, aligned end, phase durations) per round
    covered by this incarnation's ``fed_round`` spans.  A rounds-in-jit
    chunk (``num_rounds`` > 1) is one dispatch: its wall interval is
    split evenly across its rounds and its phase work attributed to
    each covered round at 1/num_rounds — the same even attribution the
    Trainer's round-seconds histogram applies.

    Phase events are bucketed ONCE (sorted by start, window lookups by
    bisection): a rescans-per-span loop would be quadratic in trace
    size, and ``obs.trace_capacity`` defaults to 200k events."""
    from bisect import bisect_left, bisect_right

    spans: list[tuple[int, int, float, float]] = []
    phase_evs: list[tuple[float, str, float]] = []  # (start, name, dur_ms)
    for e in tr.events:
        if e.get("ph") != "X":
            continue
        name = e.get("name")
        if name == "fed_round":
            args = e.get("args", {})
            if args.get("step_num") is None:
                continue
            start = tr.epoch_unix + float(e.get("ts", 0.0)) / 1e6 + corr
            end = start + float(e.get("dur", 0.0)) / 1e6
            spans.append(
                (int(args["step_num"]),
                 max(int(args.get("num_rounds", 1)), 1), start, end)
            )
        elif name in ROUND_PHASES:
            s = tr.epoch_unix + float(e.get("ts", 0.0)) / 1e6 + corr
            phase_evs.append((s, name, float(e.get("dur", 0.0)) / 1e3))
    phase_evs.sort(key=lambda p: p[0])
    phase_starts = [p[0] for p in phase_evs]
    out: list[tuple[int, float, float, dict[str, float]]] = []
    for first, n, start, end in spans:
        phases: dict[str, float] = {}
        for i in range(bisect_left(phase_starts, start),
                       bisect_right(phase_starts, end)):
            _, name, dur_ms = phase_evs[i]
            phases[name] = phases.get(name, 0.0) + dur_ms
        per = (end - start) / n
        for i in range(n):
            out.append((
                first + i, start + i * per, start + (i + 1) * per,
                {k: v / n for k, v in phases.items()},
            ))
    return out


def attribute_critical_path(workers: dict[str, WorkerData]) -> list[dict]:
    """Per-round straggler attribution over the aligned fleet timeline.

    For each round any worker recorded, the worker whose ``fed_round``
    interval ENDS last gated the barrier (the next round's broadcast
    waits on the slowest member).  ``gate_ms`` is the straggler's
    MARGINAL delay — how much later it finished than the runner-up,
    i.e. the round-time saving if only this worker were fixed (the
    barrier would then release at the runner-up's end); ``phase`` is
    the gating worker's dominant round-work span (ms, from
    :data:`ROUND_PHASES`)."""
    offsets = estimate_clock_offsets(workers)
    per_round: dict[int, list[tuple[str, float, float, dict]]] = {}
    for wid, w in workers.items():
        for i, tr in enumerate(w.traces):
            for r, start, end, phases in _round_intervals(
                tr, offsets.get((wid, i), 0.0)
            ):
                per_round.setdefault(r, []).append((wid, start, end, phases))
    rows: list[dict] = []
    for r in sorted(per_round):
        entries = per_round[r]
        # one entry per worker: a replayed round keeps its LAST attempt
        by_worker: dict[str, tuple[str, float, float, dict]] = {}
        for ent in sorted(entries, key=lambda t: t[2]):
            by_worker[ent[0]] = ent
        ents = list(by_worker.values())
        crit = max(ents, key=lambda t: t[2])
        others = [e for e in ents if e[0] != crit[0]]
        gate_ms = (
            (crit[2] - max(e[2] for e in others)) * 1e3 if others else 0.0
        )
        phase = (
            max(crit[3], key=crit[3].get) if crit[3] else None
        )
        rows.append({
            "round": r,
            "critical_worker": crit[0],
            "round_ms": round((crit[2] - crit[1]) * 1e3, 3),
            "gate_ms": round(max(gate_ms, 0.0), 3),
            "phase": phase,
            "workers": {
                e[0]: round((e[2] - e[1]) * 1e3, 3) for e in ents
            },
        })
    return rows


# ------------------------------------------------------------- fleet report
def _snap_value(snap: dict | None, name: str, labels: dict | None = None):
    from fedrec_tpu_torch.obs.report import snapshot_value

    return snapshot_value(snap, name, labels) if snap else None


def build_fleet_report(workers: dict[str, WorkerData]) -> dict:
    """The fleet's one-artifact answer: per-worker identity/epoch/rounds,
    the membership timeline (from the service's own artifacts when it
    wrote them), per-round critical-path attribution with per-worker
    times-on-critical-path totals, and per-worker DCN bytes."""
    from fedrec_tpu_torch.obs.report import _metric_values

    report: dict[str, Any] = {"workers": {}}
    service_snap = None
    for wid in sorted(workers):
        w = workers[wid]
        snap = w.last_snapshot()
        fleet = (snap or {}).get("fleet", {})
        info: dict[str, Any] = {
            "rank": fleet.get("rank"),
            "membership_epoch": fleet.get(
                "membership_epoch", _snap_value(snap, "fed.membership_epoch")
            ),
            "incarnations": len(w.traces),
            "spans": sum(len(t.events) for t in w.traces),
            "snapshots": len(w.snapshots),
        }
        rounds = _snap_value(snap, "train.rounds_total")
        if rounds is not None:
            info["rounds_total"] = rounds
        loss = _snap_value(snap, "train.round_loss")
        if loss is not None:
            info["last_loss"] = loss
        # the service registers its counters even before any shrink, so
        # detection keys on registration, not on a nonzero value
        if "fed.membership_shrinks_total" in (snap or {}).get("metrics", {}):
            service_snap = snap
            info["role"] = "membership_service"
        report["workers"][wid] = info

    if service_snap is not None:
        mem: dict[str, Any] = {}
        for key, name in (
            ("epoch", "fed.membership_epoch"),
            ("world", "fed.membership_world"),
            ("shrinks", "fed.membership_shrinks_total"),
            ("rejoins", "fed.membership_rejoins_total"),
            ("lease_misses", "fed.membership_lease_misses_total"),
        ):
            v = _snap_value(service_snap, name)
            if v is not None:
                mem[key] = v
        # the epoch timeline from the service's formation instants
        timeline = []
        for wid, w in workers.items():
            if report["workers"][wid].get("role") != "membership_service":
                continue
            for tr in w.traces:
                for e in tr.events:
                    if e.get("name") == "membership_epoch_formed":
                        a = e.get("args", {})
                        timeline.append({
                            "epoch": a.get("epoch"), "world": a.get("world"),
                        })
        if timeline:
            mem["epoch_history"] = timeline
        report["membership"] = mem

    rounds = attribute_critical_path(workers)
    if rounds:
        report["rounds"] = rounds
        counts: dict[str, int] = {}
        gated: dict[str, float] = {}
        for row in rounds:
            c = row["critical_worker"]
            counts[c] = counts.get(c, 0) + 1
            gated[c] = gated.get(c, 0.0) + row["gate_ms"]
        report["critical_path"] = {
            wid: {"rounds": counts[wid], "gate_ms": round(gated[wid], 3)}
            for wid in sorted(counts)
        }

    dcn: dict[str, Any] = {}
    for wid in sorted(workers):
        snap = workers[wid].last_snapshot()
        if snap is None:
            continue
        up = {
            row["labels"].get("path", "?"): row["value"]
            for row in _metric_values(snap, "fed.dcn_bytes_up_total")
            if "value" in row and row["value"] > 0
        }
        if up:
            dcn[wid] = {"bytes_up": up}
            down = {
                row["labels"].get("path", "?"): row["value"]
                for row in _metric_values(snap, "fed.dcn_bytes_down_total")
                if "value" in row and row["value"] > 0
            }
            if down:
                dcn[wid]["bytes_down"] = down
    if dcn:
        report["dcn_bytes"] = dcn

    # ---- quality (obs.quality): per-worker corpus AUC, the worst eval
    # slice, calibration and serving drift — the fleet view of the sliced
    # eval telemetry, compacted from the ONE shared extraction
    # (report.quality_detail_from_snapshot). Silent when no worker
    # published quality gauges.
    from fedrec_tpu_torch.obs.report import quality_detail_from_snapshot

    quality: dict[str, Any] = {}
    for wid in sorted(workers):
        snap = workers[wid].last_snapshot()
        if snap is None:
            continue
        detail = quality_detail_from_snapshot(snap)
        if not detail:
            continue
        qw: dict[str, Any] = {}
        slices_d = {
            k: m for k, m in detail.get("slices", {}).items() if "auc" in m
        }
        if "all" in slices_d:
            qw["auc"] = slices_d["all"]["auc"]
        named = {k: m["auc"] for k, m in slices_d.items() if k != "all"}
        if named:
            worst = min(named, key=named.get)
            qw["worst_slice"] = worst
            qw["worst_slice_auc"] = named[worst]
        for key in ("ece", "quality_outlier_client_evals"):
            if key in detail:
                qw[key] = detail[key]
        drift = detail.get("drift", {})
        for key, src in (
            ("drift_rank_churn", "rank_churn"),
            ("drift_score_shift_mean", "score_shift_mean"),
        ):
            if src in drift:
                qw[key] = drift[src]
        if qw:
            quality[wid] = qw
    if quality:
        report["quality"] = quality

    # ---- perf (obs.perf): per-worker last-round MFU/throughput and the
    # dominant roofline verdict — the fleet view of the live efficiency
    # gauges, compacted from the ONE shared extraction
    # (report.perf_detail_from_snapshot). Silent when no worker published
    # perf gauges.
    from fedrec_tpu_torch.obs.report import perf_detail_from_snapshot

    perf: dict[str, Any] = {}
    for wid in sorted(workers):
        snap = workers[wid].last_snapshot()
        if snap is None:
            continue
        detail = perf_detail_from_snapshot(snap)
        if not detail:
            continue
        pw = {
            key: detail[key]
            for key in (
                "samples_per_sec", "mfu", "hbm_fraction", "verdict",
                "host_ms_per_step", "dispatch_ms_per_step",
            )
            if key in detail
        }
        if pw:
            perf[wid] = pw
    if perf:
        report["perf"] = perf

    # ---- aggregation (agg.server): the async commit authority's
    # quorum/staleness accounting and each worker's marginal commit gate.
    # gate_ms BEFORE going async is the barrier critical path ("Critical
    # path" above: the slowest worker gates everyone); AFTER it is
    # agg.worker_gate_ms — a straggler that never closes a quorum stays
    # ~0 there. Silent when no worker published agg.* metrics.
    agg: dict[str, Any] = {}
    for wid in sorted(workers):
        snap = workers[wid].last_snapshot()
        if snap is None:
            continue
        if not any(
            k.startswith("agg.") for k in (snap.get("metrics") or {})
        ):
            continue
        aw: dict[str, Any] = {}
        for key, name in (
            ("commits", "agg.commits_total"),
            ("late_folds", "agg.late_folds_total"),
            ("stale_drops", "agg.stale_drops_total"),
            ("staleness", "agg.staleness"),
            ("quorum_wait_ms", "agg.quorum_wait_ms"),
            ("gate_saved_ms", "agg.gate_saved_ms"),
            ("tier_reduce_ms", "agg.tier_reduce_ms"),
            ("commit_fold_ms", "agg.commit_fold_ms"),
            ("buffer_pending", "agg.buffer_pending"),
            ("pushes", "agg.pushes_total"),
            ("global_version", "agg.global_version"),
        ):
            v = _snap_value(snap, name)
            if v is not None:
                aw[key] = v
        gate = {
            row["labels"].get("worker", "?"): row["value"]
            for row in _metric_values(snap, "agg.worker_gate_ms")
            if "value" in row
        }
        if gate:
            # only the commit authority holds the per-worker gate cells
            aw["worker_gate_ms"] = gate
            aw["role"] = "agg_server"
        if aw:
            agg[wid] = aw
    if agg:
        report["agg"] = agg

    # ---- wire (obs.wire): per-edge request/RTT telemetry, the measured
    # clock-offset table, and the queue/wire/fold decomposition of async
    # commit latency. Silent when no worker published wire.* metrics.
    wire_edges: dict[str, list[dict]] = {}
    wire_offsets: dict[str, dict[str, float]] = {}
    for wid in sorted(workers):
        snap = workers[wid].last_snapshot()
        if snap is None:
            continue
        edges: dict[tuple[str, str], dict[str, Any]] = {}

        def _edge(lbl: dict) -> dict:
            key = (str(lbl.get("peer", "?")), str(lbl.get("op", "?")))
            return edges.setdefault(key, {"peer": key[0], "op": key[1]})

        for name, fld in (
            ("wire.requests_total", "requests"),
            ("wire.errors_total", "errors"),
            ("wire.reconnects_total", "reconnects"),
            ("wire.bytes_sent_total", "bytes_sent"),
            ("wire.bytes_recvd_total", "bytes_recvd"),
        ):
            for row in _metric_values(snap, name):
                if "value" in row:
                    _edge(row.get("labels") or {})[fld] = row["value"]
        for name, fld in (
            ("wire.rtt_ms", "rtt_ms"),
            ("wire.server_ms", "server_ms"),
        ):
            for row in _metric_values(snap, name):
                if row.get("count"):
                    _edge(row.get("labels") or {})[fld] = round(
                        row["sum"] / row["count"], 3
                    )
        if edges:
            wire_edges[wid] = [edges[k] for k in sorted(edges)]
        offs = {
            str((row.get("labels") or {}).get("peer", "?")):
                round(row["value"], 3)
            for row in _metric_values(snap, "wire.clock_offset_ms")
            if "value" in row
        }
        if offs:
            wire_offsets[wid] = offs
    if wire_edges or wire_offsets:
        wire: dict[str, Any] = {}
        if wire_edges:
            wire["edges"] = wire_edges
            slowest = None
            for wid, rows in wire_edges.items():
                for e in rows:
                    if "rtt_ms" in e and (
                        slowest is None or e["rtt_ms"] > slowest["rtt_ms"]
                    ):
                        slowest = {
                            "worker": wid, "peer": e["peer"],
                            "op": e["op"], "rtt_ms": e["rtt_ms"],
                        }
            if slowest:
                wire["slowest_edge"] = slowest
        if wire_offsets:
            wire["offsets_ms"] = wire_offsets
        # queue vs wire vs fold: the commit authority's quorum wait and
        # fold time, plus each pushing worker's transport share (its
        # push edge's RTT minus the echoed server handling time)
        queue_ms = fold_ms = None
        for aw in (report.get("agg") or {}).values():
            if aw.get("role") == "agg_server":
                queue_ms = aw.get("quorum_wait_ms")
                fold_ms = aw.get("commit_fold_ms")
        decomp_edges: dict[str, dict[str, Any]] = {}
        for wid, rows in wire_edges.items():
            for e in rows:
                if e["op"] == "push" and "rtt_ms" in e:
                    srv = e.get("server_ms", 0.0)
                    decomp_edges[wid] = {
                        "peer": e["peer"],
                        "rtt_ms": e["rtt_ms"],
                        "server_ms": srv,
                        "wire_ms": round(max(e["rtt_ms"] - srv, 0.0), 3),
                    }
        if queue_ms is not None or fold_ms is not None or decomp_edges:
            decomp: dict[str, Any] = {}
            if queue_ms is not None:
                decomp["queue_ms"] = queue_ms
            if fold_ms is not None:
                decomp["fold_ms"] = fold_ms
            if decomp_edges:
                decomp["edges"] = decomp_edges
            wire["commit_decomposition"] = decomp
        report["wire"] = wire

    # ---- alerts (obs.watch): every worker's {"kind":"alert"} lifecycle
    # records, the fleet rules' worker_fleet log included. The active set
    # is computed PER worker, so two workers' identical keys (each runs
    # its own slo:round_time) keep independent lifecycles.
    from fedrec_tpu_torch.obs.watch import active_alerts, alert_records

    timeline: list[dict] = []
    active: list[dict] = []
    for wid in sorted(workers):
        recs = alert_records(workers[wid].records)
        for r in recs:
            r.setdefault("labels", {}).setdefault("worker", wid)
        timeline.extend(recs)
        active.extend(active_alerts(recs))
    if timeline:
        timeline.sort(key=lambda r: r.get("ts", 0.0))
        report["alerts"] = {
            "transitions": len(timeline),
            "active": active,
            "recent": timeline[-12:],
        }
    return report


def render_fleet_text(report: dict) -> str:
    """Human-readable fleet report (the ``fedrec-obs fleet`` output)."""
    lines = ["# fedrec_tpu fleet report", ""]
    lines.append("## Workers")
    header = f"{'worker':<14} {'rank':>4} {'epoch':>5} {'rounds':>6} " \
             f"{'spans':>7} {'snaps':>5}"
    lines.append(header)
    for wid, info in report.get("workers", {}).items():
        rank = info.get("rank")
        epoch = info.get("membership_epoch")
        label = wid + ("*" if info.get("role") == "membership_service" else "")
        lines.append(
            f"{label:<14} {('-' if rank is None else int(rank)):>4} "
            f"{('-' if epoch is None else int(epoch)):>5} "
            f"{int(info.get('rounds_total', 0)):>6} "
            f"{int(info.get('spans', 0)):>7} {int(info.get('snapshots', 0)):>5}"
        )
    if any(
        i.get("role") == "membership_service"
        for i in report.get("workers", {}).values()
    ):
        lines.append("(* = membership service)")
    lines.append("")
    al = report.get("alerts")
    if al:
        lines.append("## Alerts")
        lines.append(f"transitions: {int(al.get('transitions', 0))}")
        if al.get("active"):
            lines.append(f"STILL FIRING ({len(al['active'])}):")
            for r in al["active"]:
                w = (r.get("labels") or {}).get("worker", "?")
                lines.append(
                    f"  [{r.get('severity', '?')}] worker {w} "
                    f"{r.get('key', '?')}: {r.get('summary', '')}"
                )
        else:
            lines.append("active: none (every fired alert resolved)")
        for r in (al.get("recent") or [])[-6:]:
            w = (r.get("labels") or {}).get("worker", "?")
            lines.append(
                f"  {r.get('event', '?'):<9} worker {w} {r.get('key', '?')}"
            )
        lines.append("")
    mem = report.get("membership")
    if mem:
        lines.append("## Membership")
        lines.append(
            f"epoch: {int(mem.get('epoch', -1))}, "
            f"world: {int(mem.get('world', 0))}, "
            f"shrinks: {int(mem.get('shrinks', 0))}, "
            f"rejoins: {int(mem.get('rejoins', 0))}, "
            f"lease misses: {int(mem.get('lease_misses', 0))}"
        )
        hist = mem.get("epoch_history")
        if hist:
            lines.append(
                "epoch history: "
                + " -> ".join(
                    f"e{h.get('epoch')}@{h.get('world')}w" for h in hist
                )
            )
        lines.append("")
    rounds = report.get("rounds")
    if rounds:
        lines.append("## Critical path (per round)")
        lines.append(
            f"{'round':>5} {'worker':<12} {'round_ms':>10} {'gate_ms':>9} "
            f"{'phase':<12}"
        )
        for row in rounds:
            lines.append(
                f"{row['round']:>5} {row['critical_worker']:<12} "
                f"{row['round_ms']:>10} {row['gate_ms']:>9} "
                f"{row.get('phase') or '-':<12}"
            )
        lines.append("")
    crit = report.get("critical_path")
    if crit:
        lines.append("## Times on critical path")
        for wid, c in crit.items():
            lines.append(
                f"worker {wid}: {c['rounds']} round(s), "
                f"{c['gate_ms']:.1f} ms gated"
            )
        lines.append("")
    dcn = report.get("dcn_bytes")
    if dcn:
        lines.append("## DCN bytes by worker")

        def _mb(n: float) -> str:
            return f"{n / (1024 * 1024):.2f} MB"

        for wid, d in dcn.items():
            up = ", ".join(
                f"{p}={_mb(v)}" for p, v in sorted(d["bytes_up"].items())
            )
            lines.append(f"worker {wid}: up {up}")
        lines.append("")
    quality = report.get("quality")
    if quality:
        lines.append("## Quality by worker")
        for wid, qw in quality.items():
            parts = []
            if "auc" in qw:
                parts.append(f"auc={qw['auc']:.4f}")
            if "worst_slice" in qw:
                parts.append(
                    f"worst slice {qw['worst_slice']}="
                    f"{qw['worst_slice_auc']:.4f}"
                )
            if "ece" in qw:
                parts.append(f"ece={qw['ece']:.4f}")
            if "drift_rank_churn" in qw:
                parts.append(f"drift churn={qw['drift_rank_churn']:.3f}")
            if "quality_outlier_client_evals" in qw:
                parts.append(
                    f"outlier client-evals="
                    f"{int(qw['quality_outlier_client_evals'])}"
                )
            lines.append(f"worker {wid}: " + ", ".join(parts))
        lines.append("")
    perf = report.get("perf")
    if perf:
        lines.append("## Perf by worker")
        for wid, pw in perf.items():
            parts = []
            if "samples_per_sec" in pw:
                parts.append(f"{pw['samples_per_sec']:.1f} samples/s")
            if "mfu" in pw:
                parts.append(f"mfu={pw['mfu']:.4f}")
            if "hbm_fraction" in pw:
                parts.append(f"hbm={pw['hbm_fraction']:.3f}")
            if "host_ms_per_step" in pw:
                parts.append(f"host={pw['host_ms_per_step']:.2f}ms/step")
            if "verdict" in pw:
                parts.append(f"verdict={pw['verdict']}")
            lines.append(f"worker {wid}: " + ", ".join(parts))
        lines.append("")
    agg = report.get("agg")
    if agg:
        lines.append("## Aggregation")
        for wid, aw in agg.items():
            parts = []
            if aw.get("role") == "agg_server":
                parts.append("commit authority")
            for key, fmt in (
                ("commits", "commits={:d}"),
                ("global_version", "version={:d}"),
                ("pushes", "pushes={:d}"),
                ("late_folds", "late_folds={:d}"),
                ("stale_drops", "stale_drops={:d}"),
                ("buffer_pending", "pending={:d}"),
            ):
                if key in aw:
                    parts.append(fmt.format(int(aw[key])))
            for key, fmt in (
                ("staleness", "staleness={:.2f}"),
                ("quorum_wait_ms", "quorum_wait={:.0f}ms"),
                ("gate_saved_ms", "gate_saved={:.0f}ms"),
                ("tier_reduce_ms", "tier_reduce={:.1f}ms"),
            ):
                if key in aw:
                    parts.append(fmt.format(aw[key]))
            lines.append(f"worker {wid}: " + ", ".join(parts))
        # the before/after gate panel: barrier gate_ms (critical path,
        # above) vs each worker's async marginal gate — the async win is
        # the straggler's row reading ~0 here
        gates = {
            w: g
            for aw in agg.values()
            for w, g in (aw.get("worker_gate_ms") or {}).items()
        }
        if gates:
            crit = report.get("critical_path") or {}
            lines.append("")
            lines.append("gate_ms before (sync barrier) -> after (async commit):")
            for w in sorted(gates):
                before = crit.get(w, {}).get("gate_ms")
                before_s = "-" if before is None else f"{before:.1f}"
                lines.append(
                    f"  worker {w}: {before_s} -> {gates[w]:.1f} ms"
                )
        lines.append("")
    wire = report.get("wire")
    if wire:
        lines.append("## Wire")
        edges = wire.get("edges")
        if edges:
            lines.append(
                f"{'worker':<12} {'peer':<12} {'op':<10} {'reqs':>6} "
                f"{'errs':>5} {'rtt_ms':>9} {'srv_ms':>9}"
            )
            for wid, rows in edges.items():
                for e in rows:
                    rtt = e.get("rtt_ms")
                    srv = e.get("server_ms")
                    lines.append(
                        f"{wid:<12} {e['peer']:<12} {e['op']:<10} "
                        f"{int(e.get('requests', 0)):>6} "
                        f"{int(e.get('errors', 0)):>5} "
                        f"{('-' if rtt is None else format(rtt, '.2f')):>9} "
                        f"{('-' if srv is None else format(srv, '.2f')):>9}"
                    )
        offs = wire.get("offsets_ms")
        if offs:
            lines.append("")
            lines.append("clock offsets (peer minus worker, ms):")
            for wid, table in offs.items():
                parts = ", ".join(
                    f"{p}={v:+.1f}" for p, v in sorted(table.items())
                )
                lines.append(f"  worker {wid}: {parts}")
        slow = wire.get("slowest_edge")
        if slow:
            lines.append("")
            lines.append(
                f"slowest edge: worker {slow['worker']} -> {slow['peer']} "
                f"({slow['op']}) at {slow['rtt_ms']:.2f} ms mean RTT"
            )
        decomp = wire.get("commit_decomposition")
        if decomp:
            lines.append("")
            lines.append("async commit latency (queue vs wire vs fold):")
            head = []
            if "queue_ms" in decomp:
                head.append(
                    f"queue(quorum wait)={decomp['queue_ms']:.1f}ms"
                )
            if "fold_ms" in decomp:
                head.append(f"fold={decomp['fold_ms']:.2f}ms")
            if head:
                lines.append("  " + ", ".join(head))
            for wid, d in (decomp.get("edges") or {}).items():
                lines.append(
                    f"  worker {wid} -> {d['peer']}: "
                    f"wire={d['wire_ms']:.2f}ms "
                    f"(rtt {d['rtt_ms']:.2f} - server {d['server_ms']:.2f})"
                )
        lines.append("")
    if not report.get("workers"):
        lines.append("(no workers found)")
    return "\n".join(lines)


# ------------------------------------------------------------- collector CLI
def main(argv: list[str] | None = None) -> None:
    """Standalone fleet telemetry collector: ``python -m
    fedrec_tpu_torch.obs.fleet HOST:PORT --dir D``.  With ``--watch`` the
    fleet-level watch rules (:class:`fedrec_tpu_torch.obs.watch.FleetRules`)
    evaluate per push and their alert records land in
    ``D/worker_fleet/metrics.jsonl`` — read by ``fedrec-obs alerts D``
    like any other worker's log.  (The membership service offers the
    same sink on its own port via ``--telemetry-dir``.)"""
    import argparse

    parser = argparse.ArgumentParser(
        description="standalone fleet telemetry collector"
    )
    parser.add_argument("address", help="host:port to listen on")
    parser.add_argument(
        "--dir", required=True, help="collector artifact directory"
    )
    parser.add_argument(
        "--watch", action="store_true",
        help="evaluate fleet-level watch rules on every push "
             "(straggler / quorum-wait growth / stalled commit)",
    )
    parser.add_argument(
        "--target-world", type=int, default=0,
        help="world size the fleet:world_below_target rule compares "
             "against (0 disables the rule)",
    )
    parser.add_argument(
        "--straggler-factor", type=float, default=None,
        help="override obs.watch.fleet_straggler_factor for the "
             "persistent-straggler rule",
    )
    parser.add_argument(
        "--straggler-evals", type=int, default=None,
        help="override obs.watch.fleet_straggler_evals (consecutive "
             "breaching pushes before the straggler alert fires)",
    )
    parser.add_argument(
        "--jsonl-max-mb", type=float, default=256.0,
        help="per-worker log rotation bound",
    )
    args = parser.parse_args(argv)
    host, _, port = args.address.rpartition(":")
    collector = TelemetryCollector(args.dir, jsonl_max_mb=args.jsonl_max_mb)
    if args.watch:
        from fedrec_tpu_torch.config import WatchConfig
        from fedrec_tpu_torch.obs.watch import FleetRules

        wcfg = WatchConfig()
        if args.straggler_factor is not None:
            wcfg.fleet_straggler_factor = args.straggler_factor
        if args.straggler_evals is not None:
            wcfg.fleet_straggler_evals = args.straggler_evals
        fleet_dir = Path(args.dir) / "worker_fleet"
        fleet_dir.mkdir(parents=True, exist_ok=True)
        collector.rules = FleetRules(
            wcfg,
            target_world=args.target_world,
            jsonl_path=fleet_dir / "metrics.jsonl",
        )
    server = CollectorServer(collector, host or "127.0.0.1", int(port))
    server.start()
    print(
        f"[collector] listening on {server.address} dir={args.dir}"
        + (" watch=on" if args.watch else ""),
        flush=True,
    )
    try:
        while True:
            time.sleep(2.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
