"""Wire-layer observability, the port of ``fedrec_tpu/obs/wire.py``:
trace-context envelopes, per-edge telemetry and NTP-style clock offsets for
the TCP JSON-lines exchanges (host only: it imports no torch).

Every exchange between the port's processes is a JSON object on a TCP
socket: the fleet collector, the membership service and the async commit
authority share one one-shot exchange (``obs.fleet.serve_json_line`` /
``request_json_line``), and the serving server speaks JSON lines over
persistent asyncio connections. All of them carry one additive key:

* trace context: a request carries ``{"_wire": {trace_id, span_id,
  send_ts, op, src}}``; the receiver records a ``wire.serve`` span linked
  to the sender's ``wire.request`` by Perfetto flow events (``ph`` s/t/f
  with a shared ``id``), so the merged fleet trace draws arrows from a
  worker's push through the authority's commit to the adoption;
* clock offsets: the reply echoes ``{recv_ts, reply_ts}``; with the
  sender's ``send_ts`` and arrival ``ack_ts`` the estimate is
  ``((recv - send) + (reply - ack)) / 2`` (receiver clock minus sender
  clock), the median of a sliding window per edge, published as
  ``wire.clock_offset_ms{peer}``; ``obs.fleet.estimate_clock_offsets``
  aligns the processes that share no ``fed_round`` span (the authority,
  the membership service) by it. Its bias is at most half the path
  asymmetry (the NTP bound);
* per-edge telemetry: ``wire.{bytes_sent,bytes_recvd,requests,errors,
  reconnects}_total{peer,op}`` and the ``wire.rtt_ms`` / ``wire.server_ms``
  histograms, read by ``fedrec-obs fleet``'s Wire panel.

The contract is the JAX package's, so either package's client talks to
either's service: the envelope is additive; a receiver strips it before
dispatch and echoes a reply envelope only when the request carried one;
with ``obs.wire.enabled=false`` nothing is sent and the bytes are the
pre-envelope protocol's. Spans follow the tracer's ``enabled`` switch.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from fedrec_tpu_torch.obs.registry import get_registry
from fedrec_tpu_torch.obs.tracing import get_tracer

__all__ = [
    "WIRE_KEY",
    "OffsetEstimator",
    "configure_wire",
    "wire_enabled",
    "wire_window",
    "new_trace_id",
    "new_span_id",
    "request_envelope",
    "record_client_exchange",
    "record_client_error",
    "record_reconnect",
    "unwrap_envelope",
    "server_reply_envelope",
    "record_server_exchange",
    "current_envelope",
    "serve_extra",
    "last_reply_envelope",
    "peer_offset_s",
    "reset_wire_state",
]

WIRE_KEY = "_wire"

# module switches (obs.wire.* config; configure_wire applies them)
_config_lock = threading.Lock()
_enabled = True
_window = 32


def configure_wire(enabled: bool | None = None, window: int | None = None) -> None:
    """Apply the ``obs.wire.*`` config to this process: ``enabled``
    gates the envelope entirely (off = byte-identical pre-envelope wire
    traffic), ``window`` sizes the per-edge offset median."""
    global _enabled, _window
    with _config_lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if window is not None:
            _window = max(int(window), 1)


def wire_enabled() -> bool:
    return _enabled


def wire_window() -> int:
    return _window


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> int:
    # 48-bit: comfortably unique per fleet run, JSON-safe as an int id
    return int.from_bytes(os.urandom(6), "big") or 1


# ------------------------------------------------------- offset estimation
class OffsetEstimator:
    """Sliding-window NTP-style offset estimate for one edge.

    ``add(send, recv, reply, ack)`` consumes one exchange's four
    timestamps (sender clock: send/ack; receiver clock: recv/reply) and
    returns the sample's instantaneous offset (receiver minus sender,
    seconds).  ``offset()`` is the window median, robust to the odd
    queue-delayed exchange.  The estimate's bias is bounded by half the
    forward/return path asymmetry (the NTP bound)."""

    def __init__(self, window: int = 32):
        self.samples: deque[float] = deque(maxlen=max(int(window), 1))
        self.rtts: deque[float] = deque(maxlen=max(int(window), 1))

    def add(self, send: float, recv: float, reply: float, ack: float) -> float:
        off = ((recv - send) + (reply - ack)) / 2.0
        self.samples.append(off)
        self.rtts.append(max((ack - send) - (reply - recv), 0.0))
        return off

    def offset(self) -> float | None:
        if not self.samples:
            return None
        s = sorted(self.samples)
        return s[len(s) // 2]


@dataclass
class _WireState:
    """Per-process wire bookkeeping (offset windows + peer-name cache)."""

    lock: threading.Lock = field(default_factory=threading.Lock)
    estimators: dict[str, OffsetEstimator] = field(default_factory=dict)
    # (host, port) -> the peer's self-reported fleet worker id, learned
    # from the first reply envelope so edge labels match the merged
    # fleet's worker ids instead of raw addresses
    peer_names: dict[tuple[str, int], str] = field(default_factory=dict)


_state = _WireState()


def reset_wire_state() -> None:
    """Clear offset windows and the peer-name cache (tests)."""
    global _state
    _state = _WireState()


def peer_offset_s(peer: str) -> float | None:
    """The current windowed offset estimate for ``peer`` (receiver clock
    minus this process's clock, seconds); None before any sample."""
    with _state.lock:
        est = _state.estimators.get(peer)
    return est.offset() if est is not None else None


# ----------------------------------------------------------- client side
def request_envelope(op: str) -> dict:
    """The additive trace-context envelope a client attaches under
    :data:`WIRE_KEY`.  ``src`` is this process's fleet worker id when an
    identity was stamped (lets the receiver label the edge)."""
    from fedrec_tpu_torch.obs.fleet import get_fleet_identity

    env = {
        "trace_id": new_trace_id(),
        "span_id": new_span_id(),
        "send_ts": time.time(),
        "op": str(op),
    }
    src = get_fleet_identity().get("worker")
    if src is not None:
        env["src"] = str(src)
    return env


def _peer_label(host: str, port: int, resp_env: dict | None) -> str:
    key = (str(host), int(port))
    with _state.lock:
        if isinstance(resp_env, dict) and resp_env.get("src"):
            _state.peer_names[key] = str(resp_env["src"])
        return _state.peer_names.get(key, f"{host}:{port}")


def record_client_exchange(
    host: str,
    port: int,
    op: str,
    req_env: dict,
    resp_env: dict | None,
    bytes_sent: int,
    bytes_recvd: int,
    rtt_s: float,
    ack_ts: float,
) -> str:
    """Book one completed client exchange: per-edge counters + RTT
    histogram, the windowed offset update when the reply echoed its
    receive/reply stamps, the ``wire.request`` client span and the flow
    start the receiver's span binds to.  Returns the edge's peer label."""
    peer = _peer_label(host, port, resp_env)
    reg = get_registry()
    _edge_counters(reg, peer, op, bytes_sent, bytes_recvd)
    reg.histogram(
        "wire.rtt_ms",
        "client-observed request round trip per edge",
        labels=("peer", "op"),
    ).observe(rtt_s * 1e3, peer=peer, op=op)
    if isinstance(resp_env, dict) and (
        "recv_ts" in resp_env and "reply_ts" in resp_env
    ):
        recv = float(resp_env["recv_ts"])
        reply = float(resp_env["reply_ts"])
        reg.histogram(
            "wire.server_ms",
            "receiver-side handling time echoed in the reply envelope "
            "(RTT minus this is the pure transport share)",
            labels=("peer", "op"),
        ).observe(max(reply - recv, 0.0) * 1e3, peer=peer, op=op)
        with _state.lock:
            est = _state.estimators.setdefault(
                peer, OffsetEstimator(window=_window)
            )
        est.add(float(req_env["send_ts"]), recv, reply, ack_ts)
        off = est.offset()
        if off is not None:
            reg.gauge(
                "wire.clock_offset_ms",
                "windowed NTP-style clock offset of the peer vs this "
                "process (peer clock minus ours; fleet.estimate_clock_"
                "offsets aligns barrier-less incarnations from it)",
                labels=("peer",),
            ).set(off * 1e3, peer=peer)
    tracer = get_tracer()
    end = tracer.now()
    tracer.add_span(
        "wire.request", rtt_s, end=end,
        op=op, peer=peer, trace_id=req_env.get("trace_id"),
    )
    tracer.flow("out", int(req_env["span_id"]), ts=end - rtt_s / 2.0)
    return peer


def record_client_error(host: str, port: int, op: str) -> None:
    peer = _peer_label(host, port, None)
    get_registry().counter(
        "wire.errors_total",
        "client-side request failures per edge (transport or error reply)",
        labels=("peer", "op"),
    ).inc(peer=peer, op=op)


def record_reconnect(host: str, port: int, op: str = "conn") -> None:
    peer = _peer_label(host, port, None)
    get_registry().counter(
        "wire.reconnects_total",
        "connection re-establishments per edge (persistent-connection "
        "clients; one-shot exchanges never reconnect)",
        labels=("peer", "op"),
    ).inc(peer=peer, op=op)


def _edge_counters(reg, peer: str, op: str, sent: int, recvd: int) -> None:
    reg.counter(
        "wire.requests_total",
        "JSON-lines requests completed per edge",
        labels=("peer", "op"),
    ).inc(peer=peer, op=op)
    if sent:
        reg.counter(
            "wire.bytes_sent_total",
            "request/response line bytes sent per edge",
            labels=("peer", "op"),
        ).inc(float(sent), peer=peer, op=op)
    if recvd:
        reg.counter(
            "wire.bytes_recvd_total",
            "request/response line bytes received per edge",
            labels=("peer", "op"),
        ).inc(float(recvd), peer=peer, op=op)


# ----------------------------------------------------------- server side
@dataclass
class _ServeCtx:
    env: dict
    recv_ts: float
    extra: dict = field(default_factory=dict)


_serve_ctx: contextvars.ContextVar[_ServeCtx | None] = contextvars.ContextVar(
    "fedrec_wire_serve_ctx", default=None
)


def unwrap_envelope(req: dict) -> tuple[dict, dict | None]:
    """Strip the wire envelope off an incoming request BEFORE op
    dispatch — unknown envelope keys must never leak into handlers.
    Returns ``(request_without_envelope, envelope_or_None)``."""
    if isinstance(req, dict) and isinstance(req.get(WIRE_KEY), dict):
        req = dict(req)
        return req, req.pop(WIRE_KEY)
    return req, None


def enter_serve(env: dict, recv_ts: float):
    """Expose the request envelope to the handler for the duration of
    one exchange (:func:`current_envelope` / :func:`serve_extra`);
    returns the token for :func:`exit_serve`."""
    return _serve_ctx.set(_ServeCtx(env=env, recv_ts=recv_ts))


def exit_serve(token) -> None:
    _serve_ctx.reset(token)


def current_envelope() -> dict | None:
    """The wire envelope of the request currently being served on this
    thread/task (None outside a wire-enveloped exchange).  Handlers use
    it to chain flows past the request — e.g. the commit authority links
    a push's flow id to the commit that later folds it."""
    ctx = _serve_ctx.get()
    return ctx.env if ctx is not None else None


def serve_extra(**kv: Any) -> None:
    """Merge extra keys into the CURRENT exchange's reply envelope (e.g.
    ``commit_flow`` so the adopting worker can bind the commit's flow).
    A no-op outside a wire-enveloped exchange."""
    ctx = _serve_ctx.get()
    if ctx is not None:
        ctx.extra.update(kv)


def server_reply_envelope(env: dict, recv_ts: float) -> dict:
    """The reply's envelope echo: the receiver's recv/reply stamps (the
    NTP half the sender needs), its own span id, the sender's trace id,
    this process's identity, plus any :func:`serve_extra` keys."""
    from fedrec_tpu_torch.obs.fleet import get_fleet_identity

    reply: dict[str, Any] = {
        "trace_id": env.get("trace_id"),
        "span_id": new_span_id(),
        "parent": env.get("span_id"),
        "recv_ts": recv_ts,
        "reply_ts": time.time(),
    }
    src = get_fleet_identity().get("worker")
    if src is not None:
        reply["src"] = str(src)
    ctx = _serve_ctx.get()
    if ctx is not None and ctx.extra:
        reply.update(ctx.extra)
    return reply


def record_server_exchange(
    env: dict,
    reply_env: dict,
    op: str,
    bytes_recvd: int,
    bytes_sent: int,
) -> None:
    """Book the receiver's half: per-edge counters labeled by the
    SENDER (the envelope's ``src``), the ``wire.serve`` child span, and
    the flow finish binding the sender's arrow to it."""
    peer = str(env.get("src") or "?")
    reg = get_registry()
    _edge_counters(reg, peer, op, bytes_sent, bytes_recvd)
    dur_s = max(
        float(reply_env.get("reply_ts", 0.0))
        - float(reply_env.get("recv_ts", 0.0)),
        0.0,
    )
    tracer = get_tracer()
    end = tracer.now()
    tracer.add_span(
        "wire.serve", dur_s, end=end,
        op=op, peer=peer,
        trace_id=env.get("trace_id"), parent_span=env.get("span_id"),
    )
    span_id = env.get("span_id")
    if span_id is not None:
        mid = end - dur_s / 2.0 if dur_s > 0 else end
        tracer.flow("in", int(span_id), ts=mid)


# ------------------------------------------------- last-reply plumbing
_thread_local = threading.local()


def _set_last_reply(env: dict | None) -> None:
    _thread_local.last_reply = env


def last_reply_envelope() -> dict | None:
    """The reply envelope of this thread's most recent
    ``request_json_line`` exchange (None when the peer echoed none) —
    how a caller reads :func:`serve_extra` keys the server attached,
    without the response dict itself growing new keys."""
    return getattr(_thread_local, "last_reply", None)


# -------------------------------------------------------- overhead probe
def envelope_overhead_bytes(req: dict) -> int:
    """Measured envelope cost for ``req``: serialized bytes with the
    envelope minus without."""
    bare = len(json.dumps(req).encode())
    full = len(json.dumps({**req, WIRE_KEY: request_envelope(
        str(req.get("cmd", "req"))
    )}).encode())
    return full - bare
