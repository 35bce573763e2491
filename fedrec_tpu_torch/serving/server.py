"""Long-lived TCP/JSON-lines recommendation service, the port of
``fedrec_tpu/serving/server.py`` (plain JSON lines, without the wire
trace envelope; no refresh command yet).

Wire protocol (one JSON object per line; responses carry the request's
``id`` back so clients may pipeline):

* request  ``{"id": 7, "history": [12, 94, ...], "top_k": 10,
  "deadline_ms": 50}`` ->
  response ``{"id": 7, "ids": [...], "scores": [...], "generation": 3,
  "deadline_met": true, "latency_ms": 4.1}``;
* admin    ``{"cmd": "metrics"}`` -> ``{"metrics": {...}}``;
* errors   ``{"id": ..., "error": "backpressure" | "bad_json" | ...}``.

Every batch flush reads ONE store generation and scores the whole batch
against it; per-generation scorers are cached two generations deep.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from functools import partial
from typing import Any

import numpy as np
import torch

from fedrec_tpu_torch.device import resolve_device
from fedrec_tpu_torch.obs import get_registry
from fedrec_tpu_torch.serving.batcher import Backpressure, MicroBatcher
from fedrec_tpu_torch.serving.retrieval import build_index, build_two_stage_fn
from fedrec_tpu_torch.serving.store import EmbeddingStore, EmptyStoreError

_FN_CACHE_GENERATIONS = 2
_LATENCY_WINDOW = 8192  # request latencies kept for the p50/p99 gauges


class ServingService:
    """batcher -> store -> retrieval, one object an event loop can own."""

    def __init__(
        self,
        store: EmbeddingStore,
        history_len: int,
        top_k: int = 10,
        exclude_history: bool = True,
        batch_sizes=(1, 8, 32, 128),
        flush_ms: float = 2.0,
        max_queue: int = 1024,
        num_clusters: int = 0,
        exact_threshold: int = 4096,
        registry=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.store = store
        self.top_k = int(top_k)
        self.exclude_history = exclude_history
        self.num_clusters = int(num_clusters)
        self.exact_threshold = int(exact_threshold)
        self.registry = registry or get_registry()
        self.batcher = MicroBatcher(
            self._score_batch,
            history_len=history_len,
            batch_sizes=batch_sizes,
            flush_ms=flush_ms,
            max_queue=max_queue,
            registry=self.registry,
        )
        self._fns: dict[int, Any] = {}
        self._latencies: deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._conns: set = set()  # live TCP writers; closed on stop()
        self._started_at = time.time()
        self._g_p50 = self.registry.gauge("serve.p50_ms", "median serve latency")
        self._g_p99 = self.registry.gauge("serve.p99_ms", "p99 serve latency")
        self.registry.register_collector(self._collect)

    def _collect(self) -> None:
        lat = np.asarray(self._latencies, np.float64)
        if lat.size:
            self._g_p50.set(float(np.percentile(lat, 50)))
            self._g_p99.set(float(np.percentile(lat, 99)))

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        await self.batcher.start()

    async def stop(self) -> None:
        await self.batcher.stop()
        for w in list(self._conns):
            try:
                w.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._conns.clear()
        self._collect()
        self.registry.unregister_collector(self._collect)

    def warmup(self) -> None:
        """Run every batch bucket once against the current generation, so
        the first real requests find the kernels built and the allocator's
        blocks in place."""
        gen = self.store.current()
        self._cache_fn(gen.generation, self._build_fn(gen, warm=True))

    # ------------------------------------------------------------ scoring
    def _build_fn(self, gen, warm: bool = False):
        index = build_index(
            gen.news_vecs,
            num_clusters=self.num_clusters,
            valid_mask=gen.valid_mask,
            exact_threshold=self.exact_threshold,
        )
        fn = build_two_stage_fn(
            index, top_k=self.top_k, exclude_history=self.exclude_history, device=self.device
        )
        if warm:
            for b in self.batcher.batch_sizes:
                hist = np.zeros((b, self.batcher.history_len), np.int32)
                fn(gen.user_params, torch.from_numpy(hist))[0].cpu()
        return fn

    def _cache_fn(self, generation: int, fn) -> None:
        self._fns[generation] = fn
        for g in sorted(self._fns)[:-_FN_CACHE_GENERATIONS]:
            del self._fns[g]

    def _fn_for(self, gen):
        """Generations published directly on the store build their scorer
        on first use."""
        fn = self._fns.get(gen.generation)
        if fn is None:
            fn = self._build_fn(gen)
            self._cache_fn(gen.generation, fn)
        return fn

    def _score_batch(self, hist: np.ndarray):
        """Batcher callback: one generation snapshot per batch — the
        atomic-swap contract lives in this single ``current()`` read."""
        gen = self.store.current()
        fn = self._fn_for(gen)
        ids, scores = fn(gen.user_params, torch.from_numpy(hist))
        return ids.cpu().numpy(), scores.cpu().numpy(), gen.generation

    # ------------------------------------------------------------ requests
    async def handle(self, req: dict) -> dict:
        if not isinstance(req, dict):
            return {"error": "bad_request"}
        if "cmd" in req:
            if req.get("cmd") == "metrics":
                return {"metrics": self.metrics()}
            return {"error": f"unknown_cmd: {req.get('cmd')}"}
        rid = req.get("id")
        try:
            result = await self.batcher.submit(
                req.get("history") or [], deadline_ms=req.get("deadline_ms")
            )
        except Backpressure:
            return {"id": rid, "error": "backpressure"}
        except EmptyStoreError:
            return {"id": rid, "error": "no_generation"}
        except Exception as e:  # noqa: BLE001 — per-request error isolation
            return {"id": rid, "error": f"{type(e).__name__}: {e}"}
        self._latencies.append(result.latency_ms)
        keep = result.ids >= 0
        want = req.get("top_k")
        if isinstance(want, bool):  # JSON true/false is not a count
            want = None
        if isinstance(want, int) and want >= 0:
            keep &= np.arange(result.ids.shape[0]) < want
        ids = [int(i) for i in result.ids[keep]]
        resp = {
            "id": rid,
            "ids": ids,
            "scores": [round(float(s), 5) for s in result.scores[keep]],
            "generation": result.generation,
            "deadline_met": result.deadline_met,
            "latency_ms": round(result.latency_ms, 3),
        }
        if want is not None and want > self.top_k:
            resp["top_k_capped"] = self.top_k
        return resp

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        lat = np.asarray(self._latencies, np.float64)
        out = {
            "uptime_sec": round(time.time() - self._started_at, 1),
            "latency_count": int(lat.size),
            "p50_ms": round(float(np.percentile(lat, 50)), 3) if lat.size else None,
            "p99_ms": round(float(np.percentile(lat, 99)), 3) if lat.size else None,
        }
        out.update(self.batcher.metrics())
        out.update(self.store.metrics())
        return out


# ---------------------------------------------------------------- TCP layer
async def _handle_conn(service: ServingService, reader, writer) -> None:
    write_lock = asyncio.Lock()
    tasks: set[asyncio.Task] = set()
    service._conns.add(writer)

    async def one(raw: bytes) -> None:
        try:
            req = json.loads(raw)
        except json.JSONDecodeError:
            resp: dict = {"error": "bad_json"}
        else:
            resp = await service.handle(req)
        out = (json.dumps(resp) + "\n").encode()
        async with write_lock:
            writer.write(out)
            try:
                await writer.drain()
            except ConnectionError:
                pass

    while True:
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            async with write_lock:
                writer.write(b'{"error": "line_too_long"}\n')
                try:
                    await writer.drain()
                except ConnectionError:
                    pass
            break
        if not line:
            break
        if line.strip():
            # task-per-request: requests on one connection pipeline through
            # the batcher instead of serializing on each other's latency
            t = asyncio.ensure_future(one(line))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    service._conns.discard(writer)
    try:
        writer.close()
        await writer.wait_closed()
    except ConnectionError:
        pass


# request lines carry full click histories; asyncio's 64 KiB default would
# cut off a few-thousand-click history mid-line
_LINE_LIMIT = 1 << 20


async def start_server(service: ServingService, host: str = "127.0.0.1", port: int = 0):
    """Start the batcher and the TCP listener; returns the asyncio server
    (``server.sockets[0].getsockname()`` has the bound port when 0)."""
    await service.start()
    return await asyncio.start_server(
        partial(_handle_conn, service), host, port, limit=_LINE_LIMIT
    )


async def serve_forever(
    service: ServingService,
    host: str = "127.0.0.1",
    port: int = 7607,
    metrics_every_s: float = 30.0,
) -> None:
    """Listen until SIGINT/SIGTERM, printing a metrics JSON line every
    ``metrics_every_s``. The signal only sets an event, so the in-flight
    batch completes and queued requests fail cleanly."""
    import signal

    server = await start_server(service, host, port)
    addr = server.sockets[0].getsockname()
    print(f"[serve] listening on {addr[0]}:{addr[1]}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # non-main thread
            pass

    async def beat() -> None:
        while True:
            await asyncio.sleep(metrics_every_s)
            print(json.dumps({"serve_metrics": service.metrics()}), flush=True)

    heartbeat = asyncio.ensure_future(beat())
    try:
        await stop.wait()
        print("[serve] signal received; draining", flush=True)
    finally:
        heartbeat.cancel()
        server.close()
        await server.wait_closed()
        await service.stop()
