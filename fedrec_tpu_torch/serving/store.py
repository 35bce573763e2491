"""Versioned news-embedding store with atomic hot-swap, the port of
``fedrec_tpu/serving/store.py`` (without the drift probe, the sharded
store and checkpoint restore, which later slices bring).

The store holds immutable :class:`Generation` snapshots. ``publish`` builds
the new generation completely and then swaps it in with one reference
assignment; readers call ``current()`` once per batch, so no batch ever
mixes two generations.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from fedrec_tpu_torch.obs import get_registry


class EmptyStoreError(RuntimeError):
    """``current()`` before any generation was published."""


@dataclass(frozen=True)
class Generation:
    """One immutable serving snapshot."""

    generation: int
    news_vecs: Any                    # (N, D) news-vector table (torch tensor)
    user_params: Any                  # the user-tower module that scores it
    valid_mask: np.ndarray | None     # (N,) bool; False rows never served
    round: int | None                 # federated round, when known
    source: str                       # "synthetic" | "manual" | ...
    published_at: float

    @property
    def num_news(self) -> int:
        return int(self.news_vecs.shape[0])


class EmbeddingStore:
    """Holds the current :class:`Generation` and swap bookkeeping."""

    def __init__(self, clock=time.time, registry=None):
        self._clock = clock
        self._lock = threading.Lock()
        self._gen: Generation | None = None
        self._swap_count = 0
        reg = registry or get_registry()
        self._g_generation = reg.gauge(
            "serve.generation", "embedding-store generation being served"
        )
        self._g_swaps = reg.gauge("serve.swap_count", "hot-swaps since the store was created")
        self._g_num_news = reg.gauge("serve.num_news", "catalog rows in the current generation")

    def current(self) -> Generation:
        gen = self._gen
        if gen is None:
            raise EmptyStoreError("no generation published yet")
        return gen

    def metrics(self) -> dict:
        gen = self._gen
        if gen is None:
            return {"generation": None, "swap_count": self._swap_count}
        return {
            "generation": gen.generation,
            "swap_count": self._swap_count,
            "round": gen.round,
            "source": gen.source,
            "num_news": gen.num_news,
            "staleness_sec": round(self._clock() - gen.published_at, 3),
        }

    def publish(
        self,
        news_vecs,
        user_params,
        valid_mask: np.ndarray | None = None,
        round: int | None = None,
        source: str = "manual",
    ) -> Generation:
        """Build the full new generation, then swap it in atomically. The
        first publish is generation 0 and does not count as a swap."""
        with self._lock:
            prev = self._gen
            gen = Generation(
                generation=0 if prev is None else prev.generation + 1,
                news_vecs=news_vecs,
                user_params=user_params,
                valid_mask=valid_mask,
                round=round,
                source=source,
                published_at=self._clock(),
            )
            self._gen = gen  # the one atomic publish point
            if prev is not None:
                self._swap_count += 1
            self._g_generation.set(gen.generation)
            self._g_swaps.set(self._swap_count)
            self._g_num_news.set(gen.num_news)
            return gen
