"""The quorum commit and its staleness-weighted fold (``agg.mode =
"async"``), the port of ``fedrec_tpu/agg/commit.py``, in numpy.

A commit advances the global from version ``v`` to ``v + 1`` by folding
buffered deltas (``agg.buffer.BufferEntry``):

    staleness(e) = v - e.based_on          (commits behind the global)
    w~(e)        = e.weight / (1 + staleness(e))
    global'      = global + reduce_e(w~, delta_e)

``reduce`` is the weighted mean for ``fed.robust.method == "mean"`` (so an
all-reporting commit with no staleness is the flat FedAvg update, and
``ServerOptimizer.step`` composes unchanged), or
``fed.robust.robust_reduce_tree_np`` over the delta stacks. Entries more than
``agg.staleness_cap`` commits behind are dropped (``stale_drops``).

Codecs: a per-contribution codec (int8, sign1bit, topk) is decoded when the
contribution is pushed (:func:`encode_contribution`, with the worker's
error-feedback residual), so its entry is dense; a linear sketch
(countsketch, randproj) stays a sketch, and its entries are summed in sketch
space and decoded once a commit. A robust method cannot rank sketches and
raises on them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from fedrec_tpu_torch.agg.buffer import BufferEntry
from fedrec_tpu_torch.comms import (
    SKETCH_PAYLOAD_KEY,
    codec_caps,
    decode_leaf,
    encode_leaf,
    payload_nbytes,
    validate_codec,
)
from fedrec_tpu_torch.fed.robust import robust_reduce_tree_np
from fedrec_tpu_torch.utils.pytree import tree_leaves

__all__ = ["CommitPolicy", "CommitStats", "encode_contribution", "fold_commit",
           "staleness_weight"]


@dataclass
class CommitPolicy:
    """``agg.quorum`` and ``agg.staleness_cap``."""

    quorum: int = 0                # 0 = all-reporting
    staleness_cap: int = 2

    def quorum_for(self, world: int) -> int:
        """The commit quorum under the current world: clamped to it, so a
        shrink below the configured quorum cannot stall the commits."""
        if world < 1:
            raise ValueError(f"quorum needs a world >= 1, got {world}")
        k = self.quorum if self.quorum > 0 else world
        return max(1, min(k, world))


@dataclass
class CommitStats:
    version: int = 0               # the version this commit produced
    folded: int = 0                # entries folded into the commit
    late_folds: int = 0            # folded entries with staleness > 0
    stale_drops: int = 0           # entries dropped past the cap
    mean_staleness: float = 0.0
    max_staleness: int = 0
    fold_ms: float = 0.0


def staleness_weight(staleness: int) -> float:
    """FedBuff's polynomial decay: 1 / (1 + s), s in commits behind."""
    return 1.0 / (1.0 + max(0, int(staleness)))


def encode_contribution(
    delta_leaves: list[np.ndarray],
    codec: str,
    *,
    topk_ratio: float = 0.01,
    sketch_width: float = 0.1,
    sketch_seed: int = 0,
    residual_leaves: list[np.ndarray] | None = None,
) -> tuple[list[np.ndarray], str, list[np.ndarray] | None, int]:
    """One worker's dense delta through ``fed.dcn_compress`` for the
    buffer: ``(entry_leaves, entry_codec, new_residual, encoded_nbytes)``.
    ``"none"`` passes the delta through; a per-contribution codec encodes
    (after adding ``residual_leaves`` where the codec keeps error feedback)
    and decodes at once, so the entry is dense, and returns what the encode
    dropped as the new residual; a linear sketch's entry is its per-leaf
    sketches, with no residual. The bytes are measured from the payloads
    built."""
    delta_leaves = [np.asarray(x, np.float32) for x in delta_leaves]
    if codec == "none":
        return delta_leaves, "none", None, int(sum(x.nbytes for x in delta_leaves))
    validate_codec(codec)
    caps = codec_caps(codec)
    if not caps.decodes_per_contribution:
        key = SKETCH_PAYLOAD_KEY[codec]
        payloads = [encode_leaf(x, codec, sketch_width=sketch_width, sketch_seed=sketch_seed,
                                leaf_id=j)
                    for j, x in enumerate(delta_leaves)]
        nbytes = int(sum(payload_nbytes(p) for p in payloads))
        return [p[key] for p in payloads], codec, None, nbytes

    use_ef = caps.supports_error_feedback and residual_leaves is not None
    acc = ([d + np.asarray(r, np.float32) for d, r in zip(delta_leaves, residual_leaves)]
           if use_ef else delta_leaves)
    decoded, new_residual, nbytes = [], [], 0
    for j, a in enumerate(acc):
        payload = encode_leaf(a, codec, topk_ratio, leaf_id=j)
        nbytes += payload_nbytes(payload)
        d = decode_leaf(payload, codec, a.shape, leaf_id=j)
        decoded.append(d)
        new_residual.append(a - d)
    return (decoded, "none", new_residual if caps.supports_error_feedback else None,
            int(nbytes))


def fold_commit(
    base_leaves: list[np.ndarray],
    entries: list[BufferEntry],
    version: int,
    policy: CommitPolicy,
    method: str = "mean",
    trim_k: int = 1,
    clip_norm: float = 10.0,
    sketch_seed: int = 0,
) -> tuple[list[np.ndarray], CommitStats]:
    """Fold ``entries`` into ``base_leaves`` (the version-``version``
    global) and return the version-``version + 1`` leaves and the commit's
    accounting. An entry from a version ahead of ``version`` raises; entries
    past the staleness cap are dropped; an all-dropped commit returns the
    base at the bumped version. Sketch entries sum in sketch space and
    decode once a leaf (``sketch_seed`` is the encoders'); dense and sketch
    entries share one weight normalizer. The arithmetic is the JAX
    package's: f64 sums, the result cast to each base leaf's dtype."""
    t0 = time.monotonic()
    stats = CommitStats(version=version + 1)
    fold: list[BufferEntry] = []
    stales: list[int] = []
    for e in entries:
        s = version - e.based_on
        if s < 0:
            raise ValueError(f"entry from {e.worker!r} based_on={e.based_on} is ahead of the "
                             f"global version {version}")
        if s > policy.staleness_cap:
            stats.stale_drops += 1
            continue
        fold.append(e)
        stales.append(s)
    if not fold:
        stats.fold_ms = (time.monotonic() - t0) * 1e3
        return [np.asarray(x) for x in base_leaves], stats

    sketch_codecs = sorted({e.codec for e in fold if e.codec != "none"})
    if method != "mean" and sketch_codecs:
        raise ValueError(
            f"fed.robust.method={method!r} cannot fold sketch-coded entries (codecs "
            f"{sketch_codecs} in the buffer): order statistics rank per-contribution deltas, "
            "but a sketch entry's contribution only exists after the summed decode. Push "
            "per-contribution codecs (int8/sign1bit/topk) or fed.dcn_compress='none' to async "
            "workers under a robust fold, or set fed.robust.method='mean'.")

    w = np.asarray([e.weight * staleness_weight(s) for e, s in zip(fold, stales)], np.float64)
    stats.folded = len(fold)
    stats.late_folds = sum(1 for s in stales if s > 0)
    stats.mean_staleness = float(np.mean(stales))
    stats.max_staleness = int(max(stales))

    wmask = w > 0
    total = float(np.sum(w * wmask))
    if method == "mean" or total == 0.0:
        if total == 0.0:
            delta = [np.zeros_like(np.asarray(b, np.float64)) for b in base_leaves]
        else:
            num = [np.zeros(np.asarray(b).shape, np.float64) for b in base_leaves]
            dense_ix = [i for i, e in enumerate(fold) if e.codec == "none"]
            if dense_ix:
                wd, md = (w * wmask)[dense_ix], wmask[dense_ix]
                for j in range(len(base_leaves)):
                    stack = np.stack([np.asarray(fold[i].leaves[j], np.float64)
                                      for i in dense_ix], axis=0)
                    num[j] += np.einsum("p,p...->...", wd, np.where(
                        md.reshape((-1,) + (1,) * (stack.ndim - 1)), stack, 0.0))
            for codec in sketch_codecs:
                ix = [i for i, e in enumerate(fold) if e.codec == codec]
                ws = (w * wmask)[ix]
                key = SKETCH_PAYLOAD_KEY[codec]
                for j, b in enumerate(base_leaves):
                    # the weighted reduce over sketches, one decode a leaf
                    sk = np.einsum("p,p...->...", ws, np.stack(
                        [np.asarray(fold[i].leaves[j], np.float64) for i in ix], axis=0))
                    num[j] += np.asarray(decode_leaf(
                        {key: sk.astype(np.float32)}, codec, tuple(np.asarray(b).shape),
                        sketch_seed=sketch_seed, leaf_id=j), np.float64)
            delta = [n / total for n in num]
    else:
        # robust methods reduce the delta stacks; an all-non-finite
        # coordinate falls back to 0 (the global stays)
        stacks = [np.stack([np.asarray(e.leaves[j], np.float64) for e in fold], axis=0)
                  for j in range(len(base_leaves))]
        reduced = robust_reduce_tree_np(
            stacks, w, method, trim_k=trim_k, clip_norm=clip_norm,
            fallback_tree=[np.zeros_like(np.asarray(b)) for b in base_leaves])
        delta = tree_leaves(reduced)
    out = [np.asarray(b, np.float64) + d for b, d in zip(base_leaves, delta)]
    out = [o.astype(np.asarray(b).dtype) for o, b in zip(out, base_leaves)]
    stats.fold_ms = (time.monotonic() - t0) * 1e3
    return out, stats
