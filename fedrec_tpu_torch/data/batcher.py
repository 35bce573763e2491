"""Static-shape batch construction, a numpy copy of
``fedrec_tpu/data/batcher.py`` (``Batch``, ``IndexedSamples``,
``index_samples``, ``shard_indices``, ``process_shard_indices``,
``TrainBatcher``): the same seeds give
the same arrays as the JAX package's batcher (``tests/test_torch_train.py``).

  * candidates: (B, 1 + npratio) int32 news indices, positive at slot 0 and
    label fixed to 0 (reference ``dataset.py:83,85-86``)
  * history:    (B, max_his_len) int32, most-recent-last, padded with 0
  * his_len:    (B,) int32 true history lengths
  * labels:     (B,) int32, always 0

Per-epoch negative re-sampling matches the reference's ``newsample`` call in
``__getitem__`` (fresh negatives every epoch). Histories longer than
``max_his_len`` keep their most recent clicks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from fedrec_tpu_torch.data.sampling import sample_negatives_array


@dataclass
class Batch:
    candidates: np.ndarray    # (..., 1 + npratio) int32
    history: np.ndarray       # (..., max_his_len) int32
    his_len: np.ndarray       # (...,) int32
    labels: np.ndarray        # (...,) int32, always 0 (positive at slot 0)


@dataclass
class IndexedSamples:
    """Samples pre-indexed once into dense arrays (host-side)."""

    pos: np.ndarray           # (N,) int32
    neg_pools: np.ndarray     # (N, max_pool) int32, padded with 0
    neg_lens: np.ndarray      # (N,) int32
    history: np.ndarray       # (N, max_his_len) int32
    his_len: np.ndarray       # (N,) int32
    # user index per sample (the reference record's uidx field) — carried
    # for user-level telemetry (activity slices in obs.quality); None for
    # pre-existing callers that build the arrays directly
    uidx: np.ndarray | None = None

    def __len__(self) -> int:
        return self.pos.shape[0]

    def take(self, idx: np.ndarray) -> "IndexedSamples":
        """Row subset (e.g. one process's shard of the sample set)."""
        return IndexedSamples(
            pos=self.pos[idx],
            neg_pools=self.neg_pools[idx],
            neg_lens=self.neg_lens[idx],
            history=self.history[idx],
            his_len=self.his_len[idx],
            uidx=None if self.uidx is None else self.uidx[idx],
        )


def index_samples(samples: list, nid2index: dict, max_his_len: int) -> IndexedSamples:
    """One-time conversion of ``[uidx, pos, negs, his, uid]`` records to arrays."""
    n = len(samples)
    max_pool = max((len(s[2]) for s in samples), default=1)
    max_pool = max(max_pool, 1)
    pos = np.zeros(n, dtype=np.int32)
    neg_pools = np.zeros((n, max_pool), dtype=np.int32)
    neg_lens = np.zeros(n, dtype=np.int32)
    history = np.zeros((n, max_his_len), dtype=np.int32)
    his_len = np.zeros(n, dtype=np.int32)
    uidx = np.zeros(n, dtype=np.int64)
    for i, (u, p, negs, his, _) in enumerate(samples):
        uidx[i] = int(u)
        pos[i] = nid2index[p]
        neg_idx = [nid2index[x] for x in negs]
        neg_pools[i, : len(neg_idx)] = neg_idx
        neg_lens[i] = len(neg_idx)
        his_idx = [nid2index[x] for x in his][-max_his_len:]  # keep most recent
        history[i, : len(his_idx)] = his_idx
        his_len[i] = len(his_idx)
    return IndexedSamples(pos, neg_pools, neg_lens, history, his_len, uidx=uidx)


def shard_indices(
    n: int, num_shards: int, shard_id: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Equal-size round-robin shard of ``range(n)``.

    ``DistributedSampler`` parity (reference ``main.py:166``): indices are
    (optionally) shuffled, padded by wrap-around to a multiple of
    ``num_shards``, then dealt round-robin so every shard sees the same count.
    """
    idx = np.arange(n)
    if rng is not None:
        idx = rng.permutation(idx)
    total = -(-n // num_shards) * num_shards  # ceil to multiple
    if total > n:
        # tiled wrap-around pad: fills even when num_shards > 2n
        idx = np.concatenate([idx, np.resize(idx, total - n)])
    return idx[shard_id::num_shards]


def process_shard_indices(n: int, num_shards: int, shard_index: int, seed: int = 0) -> np.ndarray:
    """This process's disjoint shard of ``range(n)`` (``data.num_shards`` /
    ``data.shard_index``): a ``(seed, 0xD15C)``-seeded permutation dealt
    round-robin and sorted. Unlike ``shard_indices`` nothing is padded, so
    the shards partition the set exactly (sizes differ by at most 1)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    perm = np.random.default_rng((seed, 0xD15C)).permutation(n)
    return np.sort(perm[shard_index::num_shards])


class TrainBatcher:
    """Yields static-shape batches; optionally stacked across clients.

    ``epoch_batches``: (B, ...) batches for one client / single-program mode.
    ``epoch_batches_sharded``: (num_clients, B, ...) stacked batches, one
    row per client — the analogue of per-rank ``DistributedSampler`` shards.
    """

    def __init__(
        self,
        indexed: IndexedSamples,
        batch_size: int,
        npratio: int = 4,
        shuffle: bool = True,
        drop_remainder: bool = True,
        seed: int = 0,
    ):
        self.indexed = indexed
        self.batch_size = batch_size
        self.npratio = npratio
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed

    # ------------------------------------------------------------------
    def _epoch_order(self, epoch: int, n: int) -> np.ndarray:
        if self.shuffle:
            return np.random.default_rng((self.seed, epoch, 0xB)).permutation(n)
        return np.arange(n)

    def _assemble(self, take: np.ndarray, rng: np.random.Generator) -> Batch:
        ix = self.indexed
        negs = sample_negatives_array(
            ix.neg_pools[take], ix.neg_lens[take], self.npratio, rng
        )
        candidates = np.concatenate([ix.pos[take][:, None], negs], axis=1)
        return Batch(
            candidates=candidates.astype(np.int32),
            history=ix.history[take],
            his_len=ix.his_len[take],
            labels=np.zeros(take.shape[0], dtype=np.int32),
        )

    def num_batches(self, n: int | None = None) -> int:
        n = len(self.indexed) if n is None else n
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    # ------------------------------------------------------------------
    def epoch_batches(self, epoch: int = 0) -> Iterator[Batch]:
        n = len(self.indexed)
        order = self._epoch_order(epoch, n)
        # one sampling stream per epoch: every batch draws fresh keys, but the
        # whole epoch is reproducible from (seed, epoch)
        rng = np.random.default_rng((self.seed, epoch, 0xA))
        for b in range(self.num_batches(n)):
            take = order[b * self.batch_size : (b + 1) * self.batch_size]
            if len(take) < self.batch_size:
                # wrap-around pad (tiled, so it fills even when B > 2n)
                pad = np.resize(order, self.batch_size - len(take))
                take = np.concatenate([take, pad])
            yield self._assemble(take, rng)

    def epoch_batches_sharded(self, num_clients: int, epoch: int = 0) -> Iterator[Batch]:
        """Stacked per-client batches: arrays shaped (num_clients, B, ...)."""
        n = len(self.indexed)
        order = self._epoch_order(epoch, n)
        # order is already shuffled; shards deal round-robin over it
        shards = [order[shard_indices(n, num_clients, c)] for c in range(num_clients)]
        per_client = min(len(s) for s in shards)
        rng = np.random.default_rng((self.seed, epoch, 0xA))
        for b in range(self.num_batches(per_client)):
            client_batches = []
            for c in range(num_clients):
                take = shards[c][b * self.batch_size : (b + 1) * self.batch_size]
                if len(take) < self.batch_size:
                    pad = np.resize(shards[c], self.batch_size - len(take))
                    take = np.concatenate([take, pad])
                client_batches.append(self._assemble(take, rng))
            yield Batch(
                candidates=np.stack([cb.candidates for cb in client_batches]),
                history=np.stack([cb.history for cb in client_batches]),
                his_len=np.stack([cb.his_len for cb in client_batches]),
                labels=np.stack([cb.labels for cb in client_batches]),
            )
