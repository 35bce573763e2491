"""Bounded host-side prefetch for the training input pipeline: the port of
``fedrec_tpu/data/prefetch.py``.

The round loop's host work (the epoch's shuffle, negative sampling, batch
packing) runs serially with the device step when the loop is written
naively. :class:`Prefetcher` moves it onto one producer thread with a
bounded handoff queue, so batch t+1 is built while step t runs; the bound
(``data.prefetch_batches``, 2 = double buffering) keeps host memory flat.

* **Determinism**: one producer consumes the source in order into a FIFO,
  so the consumer sees exactly the batches, in exactly the order, of the
  bare iterator. Prefetch changes the schedule, never the data.
* **Bounded depth**: the producer blocks once ``depth`` items wait.
* **Clean shutdown**: a producer-side exception is re-raised in the
  consumer at the position of the item that failed; ``close()`` (or the
  end of iteration, a ``with`` block, the generator's ``close()``)
  unblocks and joins the producer thread.

The queue's health is on the port's registry (``obs``): the
``data.prefetch.queue_depth`` gauge, the producer-stall counter (queue
full: the device is the bottleneck) and the consumer-stall counter (queue
empty: batch building is), and the delivered-items counter.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

from fedrec_tpu_torch.obs import get_registry


class _Stop:
    """Sentinel: the source is exhausted."""


class _Raised:
    """Sentinel: the producer raised; carries the exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate ``source`` through a bounded background queue: at most
    ``depth`` (>= 1) items built ahead of the consumer, each through
    ``transform`` (on the producer thread) when one is given."""

    def __init__(self, source: Iterable, depth: int,
                 transform: Callable[[Any], Any] | None = None, registry=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._source = iter(source)
        self._transform = transform
        reg = registry or get_registry()
        self._depth_gauge = reg.gauge("data.prefetch.queue_depth",
                                      "batches ready in the handoff queue")
        self._producer_stalls = reg.counter(
            "data.prefetch.producer_stall_total",
            "items that waited on a full queue (device is the bottleneck)")
        self._consumer_stalls = reg.counter(
            "data.prefetch.consumer_stall_total",
            "consumer reads that found the queue empty (batch build is the bottleneck)")
        self._items = reg.counter("data.prefetch.items_total",
                                  "batches delivered through the prefetcher")
        self._thread = threading.Thread(target=self._produce, name="fedrec-prefetch",
                                        daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        """A put that stays responsive to ``close()``: False when the
        consumer has gone (the item is dropped, the producer ends)."""
        if self._q.full():
            self._producer_stalls.inc()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                self._depth_gauge.set(self._q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for item in self._source:
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item) or self._stop.is_set():
                    return
            self._put(_Stop)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._put(_Raised(e))

    def __iter__(self) -> Iterator:
        try:
            while True:
                if self._q.empty():
                    self._consumer_stalls.inc()
                item = self._q.get()
                self._depth_gauge.set(self._q.qsize())
                if item is _Stop:
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                self._items.inc()
                yield item
        finally:
            # the end, a consumer break, .close() and consumer exceptions
            self.close()

    def close(self) -> None:
        """Stop the producer and join its thread; idempotent."""
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def maybe_prefetch(source: Iterable, depth: int,
                   transform: Callable[[Any], Any] | None = None) -> Iterable:
    """A ``Prefetcher`` when ``depth`` > 0, else the bare iterable (with
    ``transform`` applied inline)."""
    if depth > 0:
        return Prefetcher(source, depth, transform)
    if transform is None:
        return source
    return (transform(item) for item in source)
