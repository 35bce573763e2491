"""Negative sampling, a numpy copy of ``fedrec_tpu/data/sampling.py`` (the
port imports nothing of the JAX package; the arrays are identical for the
same generator state, pinned in ``tests/test_torch_train.py``).

Behavioral parity with reference ``dataset.py:8-14``.

``newsample(pool, ratio)``: draw ``ratio`` negatives without replacement from
an impression's non-clicked pool; if the pool is smaller than ``ratio``, keep
the whole pool and pad with ``"<unk>"`` (index 0). The reference's global
``random`` module is replaced by an explicit ``numpy.random.Generator`` for
reproducibility across clients/hosts.
"""

from __future__ import annotations

import numpy as np

UNK = "<unk>"


def newsample(pool: list, ratio: int, rng: np.random.Generator | None = None) -> list:
    if ratio > len(pool):
        return list(pool) + [UNK] * (ratio - len(pool))
    if rng is None:
        rng = np.random.default_rng()
    idx = rng.choice(len(pool), size=ratio, replace=False)
    return [pool[i] for i in idx]


def sample_negatives_array(
    neg_pools: np.ndarray,
    neg_lens: np.ndarray,
    ratio: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Vectorized ``newsample`` over pre-indexed pools.

    ``neg_pools``: (N, max_pool) int32 of news indices, rows padded with 0.
    ``neg_lens``: (N,) actual pool sizes. Returns (N, ratio) int32 sampled
    negatives (without replacement where the pool allows; short pools keep all
    entries and pad with 0 = ``<unk>``, matching reference ``dataset.py:11-12``).
    """
    n, max_pool = neg_pools.shape
    if max_pool < ratio:
        # every pool is narrower than the request: widen with pad columns so
        # the take below always has `ratio` columns to select from
        neg_pools = np.pad(neg_pools, ((0, 0), (0, ratio - max_pool)))
        max_pool = ratio
    # random sort keys; padded slots pushed to +inf so they are never selected
    keys = rng.random((n, max_pool))
    keys = np.where(np.arange(max_pool)[None, :] < neg_lens[:, None], keys, np.inf)
    order = np.argsort(keys, axis=1)[:, :ratio]
    sampled = np.take_along_axis(neg_pools, order, axis=1)
    # rows with pool smaller than ratio: zero out the overflow slots
    valid = np.arange(ratio)[None, :] < np.minimum(neg_lens, ratio)[:, None]
    return np.where(valid, sampled, 0).astype(np.int32)
