"""The control plane's one-shot JSON-lines exchange: a copy of
``request_json_line`` and ``serve_json_line`` from ``fedrec_tpu/obs/fleet.py``
(the rest of that module, fleet telemetry, is ROADMAP.md's Queue A item 10b).

One request line in, one response line out, over a fresh TCP connection: the
membership service (``parallel.membership``) and the async commit authority
(``agg.server``) serve with :func:`serve_json_line`; their clients call with
:func:`request_json_line`, the async worker through ``parallel.rpc.FleetRpc``.

The port speaks no wire envelope (``obs.wire``, item 10b). A request that
carries one (the JAX client with wire observability on) has its ``_wire`` key
stripped before the handler sees it, and the reply echoes none, so either
package's client can talk to either package's service.
"""

from __future__ import annotations

import json
import socket

# the JAX package's envelope key (fedrec_tpu.obs.wire.WIRE_KEY)
WIRE_KEY = "_wire"


def _strip_envelope(msg):
    if isinstance(msg, dict) and WIRE_KEY in msg:
        return {k: v for k, v in msg.items() if k != WIRE_KEY}
    return msg


def request_json_line(host: str, port: int, req: dict, timeout_s: float,
                      connect_timeout_s: float | None = None) -> dict:
    """Connect, send one request line, read one response line. Raises
    ``OSError`` on a transport failure (a hang-up before a reply included:
    an ackless close is not a reply) and ``ValueError`` on a malformed or
    ``{"error": ...}`` reply.

    ``connect_timeout_s`` is the dial's deadline and ``timeout_s`` the
    exchange's, so a dead host fails in the dial's time while a live peer
    in the middle of a fold gets the whole read budget; ``None`` dials
    under ``timeout_s``."""
    line = (json.dumps(req) + "\n").encode()
    dial_s = timeout_s if connect_timeout_s is None else connect_timeout_s
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
    resp = _strip_envelope(json.loads(buf.split(b"\n", 1)[0].decode()))
    if isinstance(resp, dict) and resp.get("error"):
        raise ValueError(str(resp["error"]))
    return resp


def serve_json_line(conn: socket.socket, handler, timeout_s: float = 30.0,
                    recv_bytes: int = 1 << 20) -> None:
    """Read one request line from ``conn`` (``recv_bytes`` a read) and answer
    ``handler(request)`` as one response line, then close. A torn or
    malformed request answers ``{"error": "bad request"}`` where it can, and
    nothing raises."""
    with conn:
        try:
            conn.settimeout(timeout_s)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(recv_bytes)
                if not chunk:
                    return  # hung up before a whole request line: no reply
                buf += chunk
            req = _strip_envelope(json.loads(buf.split(b"\n", 1)[0].decode()))
            conn.sendall((json.dumps(handler(req)) + "\n").encode())
        except (OSError, ValueError, KeyError):
            try:
                conn.sendall(b'{"error": "bad request"}\n')
            except OSError:
                pass
