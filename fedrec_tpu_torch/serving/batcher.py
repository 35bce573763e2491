"""Deadline-driven asyncio micro-batcher with fixed padded batch shapes, a
copy of ``fedrec_tpu/serving/batcher.py`` for the port.

Online recommendation traffic arrives one user at a time, but the scorer
is a batch program. The batcher coalesces pending requests and pads them up
to the SMALLEST of a few fixed bucket sizes (default 1/8/32/128), so the
scorer only ever sees ``len(batch_sizes)`` shapes, all warmed up before
traffic (in the port: kernel B's launch configuration and the caching
allocator's blocks for each bucket).

Flush policy (deadline-driven, not size-driven):

* a batch flushes as soon as the largest bucket is full, OR
* when the OLDEST pending request has waited ``flush_ms`` (bounded added
  latency even at 1 req/s), OR
* when any pending request's own deadline is about to expire — a request
  with 3 ms of slack left must not sit out a 5 ms coalescing window.

Backpressure is queue-depth based and immediate: past ``max_queue``
pending requests, ``submit`` raises :class:`Backpressure` instead of
growing an unbounded queue whose tail would all miss their deadlines
anyway (fail fast at admission, the load-shedding edge every
deadline-driven server needs).

Each response reports the batch it rode in (bucket size + occupancy) and
an honest ``deadline_met`` flag computed AFTER scoring — a served-late
response says so rather than pretending.

The scorer callable runs synchronously on the event loop.  That is
deliberate: on one host the scorer is the bottleneck resource, and
running it inline makes batch formation self-clocking — while one batch
computes, the next batch's requests pile up, so occupancy rises with
load (the classic adaptive-batching property) with zero tuning.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from fedrec_tpu_torch.obs import get_registry, get_tracer


class Backpressure(RuntimeError):
    """Queue depth exceeded ``max_queue``; request rejected at admission."""


@dataclass
class ServedResult:
    """Per-request outcome: top-k ids/scores plus serving telemetry."""

    ids: np.ndarray          # (k,) int32, -1-padded past the valid items
    scores: np.ndarray       # (k,) float32
    generation: int          # embedding-store generation that scored it
    deadline_met: bool       # finish time vs the request's own deadline
    latency_ms: float        # enqueue -> results distributed
    batch_size: int          # bucket the request rode in
    occupancy: float         # real requests / bucket size


@dataclass
class _Pending:
    history: np.ndarray      # (H,) int32, already padded/truncated
    deadline: float | None   # absolute monotonic time, None = no deadline
    enqueued: float
    future: asyncio.Future


class MicroBatcher:
    """Coalesce ``submit()`` calls into fixed-shape scored batches.

    ``score_batch(hist: (B, H) int32 ndarray) -> (ids (B, k), scores (B, k),
    generation)`` — B is always one of ``batch_sizes``.  Rows past the real
    request count are zero-padded and their outputs discarded.
    """

    def __init__(
        self,
        score_batch: Callable,
        history_len: int,
        batch_sizes: Sequence[int] = (1, 8, 32, 128),
        flush_ms: float = 2.0,
        max_queue: int = 1024,
        deadline_margin_ms: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
        tracer=None,
    ):
        if not batch_sizes or list(batch_sizes) != sorted(set(batch_sizes)):
            raise ValueError("batch_sizes must be sorted, unique, non-empty")
        self._score = score_batch
        self.history_len = int(history_len)
        self.batch_sizes = tuple(int(b) for b in batch_sizes)
        self.flush_s = flush_ms / 1e3
        self.deadline_margin_s = deadline_margin_ms / 1e3
        self.max_queue = int(max_queue)
        self._clock = clock
        self._queue: list[_Pending] = []
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._running = False
        # ---- metrics. The plain attributes stay the source of truth for
        # the wire `metrics()` dict (backward-compat keys); the registry
        # instruments mirror them for snapshots/Prometheus, plus the
        # latency histogram only the registry can hold.
        self.served = 0
        self.rejected = 0
        self.deadline_missed = 0
        self.batches_by_size: dict[int, int] = {b: 0 for b in self.batch_sizes}
        self._occupancy_sum = 0.0
        self._batches = 0
        reg = registry or get_registry()
        self.tracer = tracer or get_tracer()
        self._m_served = reg.counter("serve.requests_total", "requests served")
        self._m_rejected = reg.counter(
            "serve.rejected_total", "requests shed at admission (backpressure)"
        )
        self._m_missed = reg.counter(
            "serve.deadline_missed_total", "responses served past their deadline"
        )
        self._m_batches = reg.counter(
            "serve.batches_total", "batches flushed", labels=("bucket",)
        )
        self._m_qdepth = reg.gauge("serve.queue_depth", "pending requests")
        self._m_latency = reg.histogram(
            "serve.latency_ms", "request latency, enqueue -> results (ms)"
        )

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._task is None:
            self._running = True
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                # interpreter shutdown cancels tasks out from under us; the
                # queue drain below must still run so callers fail cleanly
                pass
            self._task = None
        for p in self._queue:  # drain: fail cleanly rather than hang callers
            if not p.future.done():
                p.future.set_exception(RuntimeError("batcher stopped"))
        self._queue.clear()

    # ------------------------------------------------------------ submit
    def _normalize(self, history) -> np.ndarray:
        """Most recent ``history_len`` clicks, zero-padded at the tail —
        the training batcher's layout, so the user encoder sees the same
        distribution it was trained on."""
        h = np.asarray(list(history)[-self.history_len:], np.int32)
        out = np.zeros(self.history_len, np.int32)
        out[: h.shape[0]] = h
        return out

    async def submit(self, history, deadline_ms: float | None = None) -> ServedResult:
        if self._task is None:
            raise RuntimeError("batcher not started")
        if len(self._queue) >= self.max_queue:
            self.rejected += 1
            self._m_rejected.inc()
            raise Backpressure(
                f"queue depth {len(self._queue)} >= max_queue {self.max_queue}"
            )
        now = self._clock()
        pending = _Pending(
            history=self._normalize(history),
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
            enqueued=now,
            future=asyncio.get_running_loop().create_future(),
        )
        self._queue.append(pending)
        self._m_qdepth.set(len(self._queue))
        self._wake.set()
        return await pending.future

    # ------------------------------------------------------------ flush loop
    def _flush_at(self) -> float:
        """Earliest moment any pending request forces a flush."""
        oldest = min(p.enqueued for p in self._queue)
        at = oldest + self.flush_s
        for p in self._queue:
            if p.deadline is not None:
                at = min(at, p.deadline - self.deadline_margin_s)
        return at

    async def _run(self) -> None:
        while self._running:
            if not self._queue:
                self._wake.clear()
                await self._wake.wait()
                continue
            now = self._clock()
            flush_at = self._flush_at()
            if len(self._queue) >= self.batch_sizes[-1] or now >= flush_at:
                self._flush_one()
                # yield so submitters queued behind the (synchronous) scorer
                # get scheduled before the next flush decision
                await asyncio.sleep(0)
                continue
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), flush_at - now)
            except (asyncio.TimeoutError, TimeoutError):
                pass

    def _flush_one(self) -> None:
        take = min(len(self._queue), self.batch_sizes[-1])
        batch, self._queue = self._queue[:take], self._queue[take:]
        self._m_qdepth.set(len(self._queue))
        bucket = next(b for b in self.batch_sizes if b >= take)
        # request lifecycle spans (enqueue -> batch -> dispatch -> reply):
        # the coalescing window ends here; its length is stamped from the
        # batcher clock, only the duration crosses to the tracer clock
        self.tracer.add_span(
            "serve.queue_wait",
            dur_s=self._clock() - min(p.enqueued for p in batch),
            bucket=bucket, n=take,
        )
        hist = np.zeros((bucket, self.history_len), np.int32)
        for i, p in enumerate(batch):
            hist[i] = p.history
        try:
            with self.tracer.span("serve.dispatch", bucket=bucket, n=take):
                ids, scores, generation = self._score(hist)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the server
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)
            return
        ids = np.asarray(ids)
        scores = np.asarray(scores)
        done = self._clock()
        self._batches += 1
        self.batches_by_size[bucket] += 1
        self._m_batches.inc(bucket=bucket)
        self._occupancy_sum += take / bucket
        with self.tracer.span("serve.reply", bucket=bucket, n=take):
            for i, p in enumerate(batch):
                met = p.deadline is None or done <= p.deadline
                if not met:
                    self.deadline_missed += 1
                    self._m_missed.inc()
                self.served += 1
                self._m_served.inc()
                latency_ms = (done - p.enqueued) * 1e3
                self._m_latency.observe(latency_ms)
                self.tracer.add_span(
                    "serve.request", dur_s=done - p.enqueued, bucket=bucket
                )
                if not p.future.done():  # caller may have been cancelled
                    p.future.set_result(
                        ServedResult(
                            ids=ids[i],
                            scores=scores[i],
                            generation=int(generation),
                            deadline_met=met,
                            latency_ms=latency_ms,
                            batch_size=bucket,
                            occupancy=take / bucket,
                        )
                    )

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        return {
            "served": self.served,
            "rejected": self.rejected,
            "deadline_missed": self.deadline_missed,
            "batches": self._batches,
            "batches_by_size": dict(self.batches_by_size),
            "mean_occupancy": round(self._occupancy_sum / self._batches, 4)
            if self._batches
            else None,
            "queue_depth": len(self._queue),
        }
