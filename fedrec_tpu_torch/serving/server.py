"""Long-lived TCP/JSON-lines recommendation service, the port of
``fedrec_tpu/serving/server.py``, with the wire envelope (``obs.wire``): a
request's ``"_wire"`` key is stripped before dispatch, and the reply echoes
an envelope only when the request carried one.

Wire protocol (one JSON object per line; responses carry the request's
``id`` back so clients may pipeline):

* request  ``{"id": 7, "history": [12, 94, ...], "top_k": 10,
  "deadline_ms": 50}`` ->
  response ``{"id": 7, "ids": [...], "scores": [...], "generation": 3,
  "deadline_met": true, "latency_ms": 4.1}``
  (plus ``"news": [nid, ...]`` when the service holds an id map);
* admin    ``{"cmd": "metrics"}`` -> ``{"metrics": {...}}``;
* admin    ``{"cmd": "prometheus"}`` -> ``{"prometheus": "<text exposition>"}``
  (the whole registry);
* admin    ``{"cmd": "alerts"}`` -> ``{"alerts": {"active": [...], "recent": [...]}}``
  (the watch layer's alerts under ``obs.slo.enabled``, else both empty);
* admin    ``{"cmd": "refresh", "snapshot_dir": "...", "token_states":
  "...npy"}`` (optional ``"valid_mask": "...npy"``, ``"dtype"``) ->
  hot-swap the store from the newest training snapshot and report the new
  generation;
* errors   ``{"id": ..., "error": "backpressure" | "bad_json" | ...}``.

Every batch flush reads ONE store generation and scores the whole batch
against it; per-generation scorers are cached two generations deep, so the
outgoing generation keeps serving while a refresh prepares the next.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
from collections import deque
from functools import partial
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.device import resolve_device, torch_dtype
from fedrec_tpu_torch.obs import get_registry
from fedrec_tpu_torch.obs import wire
from fedrec_tpu_torch.serving.batcher import Backpressure, MicroBatcher
from fedrec_tpu_torch.serving.retrieval import build_index, build_two_stage_fn
from fedrec_tpu_torch.serving.store import (
    EmbeddingStore,
    EmptyStoreError,
    load_checkpoint_params,
    restore_model,
)

_FN_CACHE_GENERATIONS = 2
# token-state rows a refresh copies to the card at a time, through two
# pinned buffers of this size (39 MB each at the defaults' (50, 768) f32 rows)
_H2D_ROWS = 256
_LATENCY_WINDOW = 8192  # request latencies kept for the p50/p99 gauges


def _elapsed_ms(t0: float, dev: torch.device) -> float:
    """Host milliseconds since ``t0``, after the device's work is done."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return (time.perf_counter() - t0) * 1e3


def _load_token_states(path: str, dev: torch.device, dtype: torch.dtype):
    """The (N, L, bert_hidden) token states of the ``.npy`` at ``path`` on
    ``dev`` in ``dtype``, with the milliseconds spent reading the file and
    then moving it to the device.

    On the card the file is read ``_H2D_ROWS`` rows at a time, by
    ``readinto`` (which releases the interpreter lock), straight into two
    pinned buffers that take turns, each sent with an asynchronous copy on
    the current stream. On the H100 a whole-file ``np.load`` held the
    interpreter lock for 0.3-0.7 s at a time and pageable copies held the
    serving thread's own copies back for up to 1.1 s, so requests stalled
    for seconds while a refresh ran (PERF.md). ``token_load_ms`` sums the
    reads; ``host_to_device_ms`` is the rest of the loop, mostly waiting
    for the copies."""
    t0 = time.perf_counter()
    if dev.type != "cuda":
        tokens = torch.from_numpy(np.load(path)).to(dtype)
        return tokens, (time.perf_counter() - t0) * 1e3, 0.0
    fmt = np.lib.format
    with open(path, "rb") as f:
        major, _ = fmt.read_magic(f)
        read_header = fmt.read_array_header_1_0 if major == 1 else fmt.read_array_header_2_0
        shape, fortran_order, file_dtype = read_header(f)
        if fortran_order or len(shape) != 3:
            raise ValueError(f"{path}: expected C-ordered (N, L, H) token states, got "
                             f"shape {shape}, fortran_order={fortran_order}")
        tokens = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, file_dtype)).dtype,
                             device=dev)
        bufs = [torch.empty((_H2D_ROWS, *shape[1:]), dtype=tokens.dtype, pin_memory=True)
                for _ in range(2)]
        sent: list = [None, None]
        read_s = 0.0
        for i, start in enumerate(range(0, shape[0], _H2D_ROWS)):
            buf = bufs[i % 2][:min(_H2D_ROWS, shape[0] - start)]
            if sent[i % 2] is not None:
                sent[i % 2].synchronize()  # the buffer's last copy is done
            t_read = time.perf_counter()
            view = memoryview(buf.numpy()).cast("B")
            got = 0
            while got < view.nbytes:
                n = f.readinto(view[got:])
                if not n:
                    raise ValueError(f"{path}: file ends before its {shape} rows")
                got += n
            read_s += time.perf_counter() - t_read
            tokens[start:start + buf.shape[0]].copy_(buf, non_blocking=True)
            sent[i % 2] = torch.cuda.Event()
            sent[i % 2].record()
    torch.cuda.current_stream(dev).synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    return tokens.to(dtype), read_s * 1e3, total_ms - read_s * 1e3


class ServingService:
    """batcher -> store -> retrieval, one object an event loop can own.

    ``model_cfg`` is the model configuration a refresh restores snapshots
    into (the JAX service's ``model``); without it ``refresh`` fails.
    ``last_build_ms`` holds ``warmup``'s index build and bucket warm-up
    milliseconds with the index's stats, ``last_refresh_ms`` the last
    refresh's parts.
    """

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
        n_probe: int = 8,
        exact_threshold: int = 4096,
        id_map: dict[int, str] | None = None,
        model_cfg: ModelConfig | None = None,
        registry=None,
        device=None,
        watch=None,
    ):
        self.device = resolve_device(device)
        # the in-process watch (obs.watch.Watch) under obs.slo.enabled: the
        # alerts admin command reads it, the heartbeat evaluates it
        self.watch = watch
        self.store = store
        self.top_k = int(top_k)
        self.exclude_history = exclude_history
        self.num_clusters = int(num_clusters)
        self.n_probe = int(n_probe)
        self.exact_threshold = int(exact_threshold)
        self.id_map = id_map
        self.model_cfg = model_cfg
        self.last_build_ms: dict[str, float] = {}
        self.last_refresh_ms: dict[str, float] = {}
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
        the first real requests (and a refresh thread's first kernel call)
        find the kernels built and the allocator's blocks in place."""
        gen = self.store.current()
        fn, self.last_build_ms = self._build_fn(gen.news_vecs, gen.valid_mask, gen.user_params)
        self._cache_fn(gen.generation, fn)

    # ------------------------------------------------------------ scoring
    def _build_fn(self, news_vecs, valid_mask, user_params=None):
        """Index + scorer for one generation's arrays, and the build's
        milliseconds; with ``user_params`` given, also run every batch bucket
        once."""
        t0 = time.perf_counter()
        index = build_index(
            news_vecs,
            num_clusters=self.num_clusters,
            n_probe=self.n_probe,
            valid_mask=valid_mask,
            exact_threshold=self.exact_threshold,
            device=self.device,
        )
        index_ms = _elapsed_ms(t0, self.device)
        fn = build_two_stage_fn(
            index, top_k=self.top_k, exclude_history=self.exclude_history, device=self.device
        )
        t0 = time.perf_counter()
        if user_params is not None:
            for b in self.batcher.batch_sizes:
                hist = np.zeros((b, self.batcher.history_len), np.int32)
                fn(user_params, torch.from_numpy(hist))[0].cpu()
        return fn, {"index_build_ms": index_ms, "warmup_ms": (time.perf_counter() - t0) * 1e3,
                    **index.stats()}

    def _cache_fn(self, generation: int, fn) -> None:
        self._fns[generation] = fn
        for g in sorted(self._fns)[:-_FN_CACHE_GENERATIONS]:
            del self._fns[g]

    def _fn_for(self, gen):
        """Generations published directly on the store build their scorer
        on first use."""
        fn = self._fns.get(gen.generation)
        if fn is None:
            fn, _ = self._build_fn(gen.news_vecs, gen.valid_mask)
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
            return await self._admin(req)
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
        if self.id_map is not None:
            resp["news"] = [self.id_map.get(i, str(i)) for i in ids]
        return resp

    async def _admin(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "metrics":
            return {"metrics": self.metrics()}
        if cmd == "alerts":
            # an unwatched server answers the empty shape, not an error
            if self.watch is not None:
                return {"alerts": self.watch.engine.snapshot_state()}
            return {"alerts": {"active": [], "recent": []}}
        if cmd == "prometheus":
            return {"prometheus": self.registry.to_prometheus()}
        if cmd == "refresh":
            try:
                prepared = await asyncio.get_running_loop().run_in_executor(
                    None, partial(self._prepare_refresh, req)
                )
            except Exception as e:  # noqa: BLE001 — a refresh must not kill serving
                return {"error": f"refresh_failed: {type(e).__name__}: {e}"}
            # publish + scorer-cache insert together ON the event loop: the
            # expensive work already happened in the executor, so the swap is
            # two reference assignments no batch flush can interleave with
            table, user_params, valid_mask, round_, source, fn = prepared
            gen = self.store.publish(table, user_params, valid_mask=valid_mask,
                                     round=round_, source=source)
            self._cache_fn(gen.generation, fn)
            if self.watch is not None:
                # a drift-probe breach on this swap pulses serve:drift,
                # scored at the next heartbeat
                self.watch.ingest_drift(self.store.metrics())
            return {"refreshed": True, "generation": gen.generation,
                    "round": gen.round, "source": gen.source}
        return {"error": f"unknown_cmd: {cmd}"}

    def _prepare_refresh(self, req: dict):
        """Restore -> token-state load -> host-to-device -> encode (kernel A)
        -> index build -> a warm-up of every bucket, in the loop's executor;
        returns what ``_admin`` needs for the on-loop publish, and records
        each part's milliseconds in ``last_refresh_ms``. In-flight batches
        keep serving the old generation from its cached scorer throughout.

        On the card the work runs on a side stream, so serving batches (on
        the default stream) do not queue behind the token states' copy
        (``_load_token_states``) or the encode, and the stream is
        synchronised before the table is handed back. The new tensors need no ``record_stream``: each batch ends in
        a host read-back before it drops its references, so when the last
        reference to a generation goes, the serving stream has no work
        pending on its blocks."""
        from fedrec_tpu_torch.train.step import encode_all_news

        if self.model_cfg is None:
            raise ValueError("this service has no model config to restore snapshots into")
        dev = self.device
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        parts: dict[str, float] = {}
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            user_state, news_state, round_, kind = load_checkpoint_params(req["snapshot_dir"])
            model = restore_model(self.model_cfg, user_state, news_state, dev)
            parts["restore_ms"] = _elapsed_ms(t0, dev)
            tokens, parts["token_load_ms"], parts["host_to_device_ms"] = _load_token_states(
                req["token_states"], dev, torch_dtype(req.get("dtype", self.model_cfg.dtype)))
            t0 = time.perf_counter()
            table = encode_all_news(model, tokens, device=dev)
            parts["encode_ms"] = _elapsed_ms(t0, dev)
            del tokens
            if "valid_mask" in req:
                valid_mask = np.load(req["valid_mask"]).astype(bool)
                if valid_mask.shape[0] != table.shape[0]:
                    raise ValueError(f"valid_mask length {valid_mask.shape[0]} != catalog "
                                     f"{table.shape[0]}")
            else:
                # reuse the serving mask only while the catalog size is
                # unchanged: a grown or shrunk corpus would shape-error (or,
                # same size reordered, validate the wrong rows), so a refresh
                # that changes N must ship its own mask or serve all
                valid_mask = self.store.current().valid_mask
                if valid_mask is not None and valid_mask.shape[0] != table.shape[0]:
                    valid_mask = None
            fn, build = self._build_fn(table, valid_mask, model.user_encoder)
            if side is not None:
                side.synchronize()
        self.last_refresh_ms = {**parts, **build}
        return table, model.user_encoder, valid_mask, round_, f"checkpoint:{kind}", fn

    # ------------------------------------------------------------ metrics
    def log_metrics(self, logger, step: int) -> None:
        """The metric snapshot through ``utils.logging.MetricLogger``
        (``serve.``-prefixed keys)."""
        logger.log(step, {f"serve.{k}": v for k, v in self.metrics().items()
                          if not isinstance(v, dict)})

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
        # the wire envelope is stripped before dispatch and echoed only when
        # the request carried one; each request is a task of its own, so
        # the serve context (a contextvar) is the task's
        recv_ts = time.time()
        env = reply_env = None
        try:
            req = json.loads(raw)
        except json.JSONDecodeError:
            resp: dict = {"error": "bad_json"}
        else:
            req, env = wire.unwrap_envelope(req)
            if env is None:
                resp = await service.handle(req)
            else:
                token = wire.enter_serve(env, recv_ts)
                try:
                    resp = await service.handle(req)
                    reply_env = wire.server_reply_envelope(env, recv_ts)
                finally:
                    wire.exit_serve(token)
                if isinstance(resp, dict):
                    resp = {**resp, wire.WIRE_KEY: reply_env}
        out = (json.dumps(resp) + "\n").encode()
        async with write_lock:
            writer.write(out)
            try:
                await writer.drain()
            except ConnectionError:
                pass
        if reply_env is not None:
            wire.record_server_exchange(env, reply_env, op=str(env.get("op") or "score"),
                                        bytes_recvd=len(raw), bytes_sent=len(out))

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
    obs_dir: str | None = None,
    jsonl_max_mb: float = 0.0,
) -> None:
    """Listen until SIGINT/SIGTERM, printing a metrics JSON line every
    ``metrics_every_s``. The signal only sets an event, so the in-flight
    batch completes and queued requests fail cleanly. With ``obs_dir``
    each beat also appends the metrics record and a registry snapshot to
    ``obs_dir/metrics.jsonl`` (rotated past ``jsonl_max_mb``), and the
    shutdown writes the artifacts (``obs.report.dump_artifacts``)."""
    import signal

    logger = None
    if obs_dir is not None:
        from fedrec_tpu_torch.utils.logging import MetricLogger

        Path(obs_dir).mkdir(parents=True, exist_ok=True)
        logger = MetricLogger(jsonl_path=str(Path(obs_dir) / "metrics.jsonl"),
                              registry=service.registry, jsonl_max_mb=jsonl_max_mb)
    step = 0

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
        nonlocal step
        while True:
            await asyncio.sleep(metrics_every_s)
            step += 1
            print(json.dumps({"serve_metrics": service.metrics()}), flush=True)
            if service.watch is not None:
                # the heartbeat-cadence tick, fed the serve.* snapshot so an
                # SLO over serve.p99_ms reads this beat's value
                service.watch.evaluate(record={
                    f"serve.{k}": v for k, v in service.metrics().items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)})
            if logger is not None:
                # periodic snapshots keep the event log useful when the
                # server is killed rather than signalled
                from fedrec_tpu_torch.obs.report import rotate_jsonl

                service.log_metrics(logger, step)
                rotate_jsonl(Path(obs_dir) / "metrics.jsonl", jsonl_max_mb)
                service.registry.write_snapshot(Path(obs_dir) / "metrics.jsonl")

    heartbeat = asyncio.ensure_future(beat())
    try:
        await stop.wait()
        print("[serve] signal received; draining", flush=True)
    finally:
        heartbeat.cancel()
        server.close()
        await server.wait_closed()
        await service.stop()
        if obs_dir is not None:
            from fedrec_tpu_torch.obs.report import dump_artifacts

            paths = dump_artifacts(obs_dir, registry=service.registry)
            print(f"[serve] obs artifacts in {obs_dir}: {', '.join(sorted(paths))}", flush=True)
