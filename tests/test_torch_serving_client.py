"""The port's resilient serving client (CPU): full-jitter backoff equal to
the JAX package's for the same seed, an unreachable server, a client-side
deadline against a server that never answers, a bad response line, and a
server restart under a ``ServingClientPool``, against the port's own
service.

Every test runs under its own ``asyncio.wait_for``. A server whose handler
never answers has its handler tasks cancelled and its writers closed
before ``wait_closed``: ``asyncio.Server.wait_closed`` waits for every open
connection, so a handler left sleeping would hang the test.
"""

import asyncio
import json
import random

import numpy as np
import pytest
import torch

from fedrec_tpu.parallel.rpc import backoff_delay_s as jax_backoff_delay_s
from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import init_params
from fedrec_tpu_torch.parallel import backoff_delay_s
from fedrec_tpu_torch.serving import (
    EmbeddingStore,
    ServingClient,
    ServingClientPool,
    ServingService,
    ServingUnavailable,
    start_server,
)

N, D, H = 200, 32, 8
_TIMEOUT_S = 30


def _service() -> ServingService:
    cfg = ModelConfig(news_dim=D, num_heads=4, head_dim=8, query_dim=16, bert_hidden=32)
    tower = init_params(NewsRecommender(cfg), seed=0).eval().user_encoder
    table = torch.randn((N, D), generator=torch.Generator().manual_seed(0))
    store = EmbeddingStore()
    store.publish(table, tower, source="synthetic")
    svc = ServingService(store, history_len=H, top_k=5, batch_sizes=(1, 8), flush_ms=1.0,
                         max_queue=256, device="cpu")
    svc.warmup()
    return svc


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, _TIMEOUT_S))


async def _silent_server(reply: bytes | None):
    """A server that answers every line with ``reply``, or never (None);
    returns it with a ``shut()`` that cancels the handlers and closes their
    writers before ``wait_closed``."""
    handlers, writers = set(), []

    async def handle(reader, writer):
        handlers.add(asyncio.current_task())
        writers.append(writer)
        while await reader.readline():
            if reply is None:
                await asyncio.sleep(3600)
            writer.write(reply)
            await writer.drain()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)

    async def shut():
        server.close()
        for t in handlers:
            t.cancel()
        for w in writers:
            w.close()
        await asyncio.gather(*handlers, return_exceptions=True)
        await server.wait_closed()

    return server.sockets[0].getsockname()[1], shut


def test_backoff_is_the_jax_packages_full_jitter():
    for attempt in range(7):
        got = [backoff_delay_s(attempt, 50, 400, random.Random(attempt)) for _ in range(3)]
        want = [jax_backoff_delay_s(attempt, 50, 400, random.Random(attempt)) for _ in range(3)]
        assert got == want
    c = ServingClient("127.0.0.1", 1, backoff_base_ms=50, backoff_max_ms=400, seed=0)
    draws = [[c.backoff_delay_s(a) for _ in range(200)] for a in range(6)]
    for a, ds in enumerate(draws):
        assert all(0.0 <= d <= min(400, 50 * 2 ** a) / 1e3 for d in ds), a
    assert np.std(draws[3]) > 0.01 and max(draws[5]) <= 0.4


def test_unreachable_server_returns_unavailable_not_raise():
    async def go():
        c = ServingClient("127.0.0.1", 1, request_timeout_ms=300, backoff_base_ms=10,
                          backoff_max_ms=50, seed=1)
        resp = await c.request({"history": [1, 2]})
        assert resp["error"] in ("unavailable", "deadline")
        with pytest.raises(ServingUnavailable):
            await c.request_or_raise({"history": [1, 2]})
        assert c.failed_requests == 2
        await c.close()

    _run(go())


@pytest.mark.parametrize("reply", [None, b"not json\n"], ids=["black_hole", "bad_response"])
def test_deadline_and_bad_response_come_back_as_errors(reply):
    async def go():
        port, shut = await _silent_server(reply)
        c = ServingClient("127.0.0.1", port, request_timeout_ms=200, seed=2)
        loop = asyncio.get_running_loop()
        try:
            t0 = loop.time()
            resp = await c.request({"history": [1]})
            elapsed = loop.time() - t0
        finally:
            await c.close()
            await shut()
        return resp, elapsed

    resp, elapsed = _run(go())
    assert resp == {"error": "deadline" if reply is None else "bad_response"}
    assert elapsed < 2.0


def test_server_restart_mid_run_degrades_not_fails():
    async def go():
        svc = _service()
        server = await start_server(svc, port=0)
        port = server.sockets[0].getsockname()[1]
        pool = ServingClientPool("127.0.0.1", port, size=2, request_timeout_ms=4000,
                                 backoff_base_ms=20, backoff_max_ms=200)

        async def fire(n):
            return [await pool.handle({"id": i, "history": [1, 2, 3]}) for i in range(n)]

        before = await fire(8)
        # a hard restart: the service's stop closes the pool's connections,
        # which wait_closed waits for
        server.close()
        await svc.stop()
        await server.wait_closed()
        c_down = ServingClient("127.0.0.1", port, request_timeout_ms=250, backoff_base_ms=10,
                               backoff_max_ms=50, seed=3)
        down = await c_down.request({"history": [1]})
        await c_down.close()
        svc2 = _service()
        server2 = await start_server(svc2, host="127.0.0.1", port=port)
        try:
            after = await fire(8)
            metrics = await pool.admin("metrics", deadline_ms=2000)
            retries = pool.retry_metrics()
        finally:
            await pool.close()
            server2.close()
            await svc2.stop()
            await server2.wait_closed()
        return before, down, after, metrics, retries

    before, down, after, metrics, retries = _run(go())
    assert all("error" not in r and len(r["ids"]) == 5 for r in before)
    assert down["error"] in ("unavailable", "deadline")
    assert all("error" not in r and r["deadline_met"] and "latency_ms" in r for r in after), after
    assert after[0]["ids"] == before[0]["ids"]  # the same seeded catalog and tower
    assert retries["reconnects"] >= 1 and retries["connections"] == 2
    assert metrics["metrics"]["served"] == 8


def test_wire_bytes_are_plain_json_lines():
    """With the trace envelope off (``obs.wire.enabled=false``) a request is
    one JSON object and a newline, as the JAX client sends it with the
    envelope off; with it on (the default) the same object carries the
    additive ``_wire`` key, and a reply without one is returned as sent."""
    from fedrec_tpu_torch.obs.wire import configure_wire, wire_enabled

    seen = []

    async def go():
        async def handle(reader, writer):
            line = await reader.readline()
            seen.append(line)
            writer.write(b'{"ok": 1}\n')
            await writer.drain()
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        c = ServingClient("127.0.0.1", server.sockets[0].getsockname()[1], seed=4)
        try:
            return await c.admin("metrics", deadline_ms=2000)
        finally:
            await c.close()
            server.close()
            await server.wait_closed()

    was = wire_enabled()
    configure_wire(enabled=False)
    try:
        assert _run(go()) == {"ok": 1}
    finally:
        configure_wire(enabled=was)
    assert seen == [(json.dumps({"cmd": "metrics"}) + "\n").encode()]
    configure_wire(enabled=True)
    try:
        assert _run(go()) == {"ok": 1}
    finally:
        configure_wire(enabled=was)
    sent = json.loads(seen[1])
    env = sent.pop("_wire")
    assert sent == {"cmd": "metrics"} and env["op"] == "metrics"
    assert {"trace_id", "span_id", "send_ts"} <= set(env)
