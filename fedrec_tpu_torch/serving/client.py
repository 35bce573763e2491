"""Resilient TCP client for the serving protocol, the port of
``fedrec_tpu/serving/client.py``, with the wire envelope (``obs.wire``):
each request carries a trace-context key, rebuilt per attempt, and each
exchange books its edge's RTT, bytes and clock offset; with
``obs.wire.enabled=false`` the bytes are the pre-envelope protocol's.

* :class:`ServingClient`: one connection that (re)connects lazily with
  exponential backoff and full jitter (``parallel.rpc.backoff_delay_s``),
  enforces a per-request deadline (``request_timeout_ms``; a per-call
  ``deadline_ms`` wins), and turns transport failures into error
  responses (``{"error": "deadline"}``, ``{"error": "unavailable"}``,
  ``{"error": "bad_response"}``) instead of exceptions, so a server
  restart degrades to latency, not a crashed caller. A timed-out request
  closes the connection (the response stream is no longer
  line-synchronized) and the next call reconnects.
* :class:`ServingClientPool`: N connections behind an ``asyncio`` queue
  with the in-process service's ``handle(request)`` surface;
  ``latency_ms`` / ``deadline_met`` are the client-side round trip.

Admin commands: ``admin("metrics")``, ``admin("refresh", snapshot_dir=...,
token_states=..., deadline_ms=...)``.
"""

from __future__ import annotations

import asyncio
import json
import random
import time

from fedrec_tpu_torch.obs import wire
from fedrec_tpu_torch.parallel.rpc import backoff_delay_s


class ServingUnavailable(ConnectionError):
    """Raised by :meth:`ServingClient.request_or_raise` when the retry
    budget is exhausted; ``request`` returns an error response instead."""


class ServingClient:
    """One JSON-lines connection with reconnect/backoff and deadlines.

    One request in flight per client (a :class:`ServingClientPool` gives
    concurrency); the response to a request is the next line, so a lost or
    timed-out request drops the connection.
    """

    def __init__(
        self,
        host: str,
        port: int,
        request_timeout_ms: float = 1000.0,
        backoff_base_ms: float = 50.0,
        backoff_max_ms: float = 2000.0,
        max_attempts: int = 8,
        seed: int | None = None,
    ):
        self.host = host
        self.port = int(port)
        self.request_timeout_ms = float(request_timeout_ms)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self.max_attempts = int(max_attempts)
        self._rng = random.Random(seed)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._was_connected = False
        self.reconnects = 0
        self.failed_requests = 0

    def backoff_delay_s(self, attempt: int) -> float:
        return backoff_delay_s(attempt, self.backoff_base_ms, self.backoff_max_ms, self._rng)

    async def _drop(self) -> None:
        w, self._reader, self._writer = self._writer, None, None
        if w is not None:
            try:
                w.close()
                await w.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _connect(self, deadline: float) -> bool:
        """(Re)connect with backoff until ``deadline`` (monotonic seconds)
        or the attempt budget runs out. True on success."""
        for attempt in range(self.max_attempts):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_connection(self.host, self.port), timeout=remaining
                )
                if self._was_connected:
                    self.reconnects += 1
                    if wire.wire_enabled():
                        wire.record_reconnect(self.host, self.port)
                self._was_connected = True
                return True
            except (OSError, asyncio.TimeoutError):
                await self._drop()
                delay = self.backoff_delay_s(attempt)
                if time.monotonic() + delay >= deadline:
                    return False
                await asyncio.sleep(delay)
        return False

    def _fail(self, error: str, op: str) -> dict:
        self.failed_requests += 1
        if wire.wire_enabled():
            wire.record_client_error(self.host, self.port, op)
        return {"error": error}

    async def request(self, payload: dict, deadline_ms: float | None = None) -> dict:
        """One request/response with retry inside the deadline: the
        server's response, or ``{"error": "deadline" | "unavailable" |
        "bad_response"}``; never raises for transport failures."""
        budget_ms = deadline_ms if deadline_ms is not None else self.request_timeout_ms
        deadline = time.monotonic() + budget_ms / 1e3
        op = str(payload.get("cmd", "score"))
        attempt = 0
        while True:
            if deadline - time.monotonic() <= 0:
                return self._fail("deadline", op)
            if self._writer is None and not await self._connect(deadline):
                return self._fail("unavailable", op)
            # a fresh envelope an attempt: a retry carries its own send_ts
            req_env = wire.request_envelope(op) if wire.wire_enabled() else None
            line = (json.dumps({**payload, wire.WIRE_KEY: req_env} if req_env is not None
                               else payload) + "\n").encode()
            t0 = time.perf_counter()
            try:
                self._writer.write(line)
                await asyncio.wait_for(self._writer.drain(), deadline - time.monotonic())
                raw = await asyncio.wait_for(self._reader.readline(),
                                             max(deadline - time.monotonic(), 0))
            except asyncio.TimeoutError:
                # the stream is no longer line-synchronized; drop it
                await self._drop()
                return self._fail("deadline", op)
            except (ConnectionError, OSError):
                raw = b""  # the server went away mid-request: retry below
            if not raw:
                # a reset or a clean EOF: reconnect and retry while the
                # deadline allows
                await self._drop()
                delay = self.backoff_delay_s(attempt)
                attempt += 1
                if time.monotonic() + delay >= deadline:
                    return self._fail("unavailable", op)
                await asyncio.sleep(delay)
                continue
            try:
                resp = json.loads(raw)
            except json.JSONDecodeError:
                await self._drop()
                return self._fail("bad_response", op)
            ack_ts = time.time()
            resp, resp_env = wire.unwrap_envelope(resp)
            if req_env is not None:
                wire.record_client_exchange(
                    self.host, self.port, op, req_env, resp_env, bytes_sent=len(line),
                    bytes_recvd=len(raw), rtt_s=time.perf_counter() - t0, ack_ts=ack_ts)
            return resp

    async def request_or_raise(self, payload: dict, deadline_ms: float | None = None) -> dict:
        resp = await self.request(payload, deadline_ms=deadline_ms)
        if resp.get("error") in ("deadline", "unavailable"):
            raise ServingUnavailable(f"{self.host}:{self.port} — {resp['error']}")
        return resp

    async def admin(self, cmd: str, deadline_ms: float | None = None, **kw) -> dict:
        """Admin command (``metrics`` / ``refresh``); a refresh loads a
        checkpoint and re-encodes the catalog, so give it a real deadline
        (e.g. ``deadline_ms=120_000``)."""
        return await self.request({"cmd": cmd, **kw}, deadline_ms=deadline_ms)

    async def close(self) -> None:
        await self._drop()


class ServingClientPool:
    """N :class:`ServingClient` connections behind a checkout queue,
    presenting the in-process service's ``handle(request)`` surface."""

    def __init__(self, host: str, port: int, size: int = 8, **client_kw):
        self.clients = [ServingClient(host, port, seed=i, **client_kw) for i in range(size)]
        self._q: asyncio.Queue = asyncio.Queue()
        for c in self.clients:
            self._q.put_nowait(c)

    async def handle(self, req: dict) -> dict:
        cli = await self._q.get()
        try:
            t0 = time.perf_counter()
            deadline_ms = req.get("deadline_ms")
            resp = await cli.request(req, deadline_ms=deadline_ms)
            rtt_ms = (time.perf_counter() - t0) * 1e3
            if "error" not in resp:
                # with a network (and reconnects) in the path, the client's
                # round trip is the latency the caller saw
                resp["latency_ms"] = rtt_ms
                resp["deadline_met"] = rtt_ms <= deadline_ms if deadline_ms else True
            return resp
        finally:
            self._q.put_nowait(cli)

    async def admin(self, cmd: str, deadline_ms: float | None = None, **kw) -> dict:
        cli = await self._q.get()
        try:
            return await cli.admin(cmd, deadline_ms=deadline_ms, **kw)
        finally:
            self._q.put_nowait(cli)

    def retry_metrics(self) -> dict:
        return {
            "connections": len(self.clients),
            "reconnects": sum(c.reconnects for c in self.clients),
            "failed_requests": sum(c.failed_requests for c in self.clients),
        }

    async def close(self) -> None:
        for c in self.clients:
            await c.close()
