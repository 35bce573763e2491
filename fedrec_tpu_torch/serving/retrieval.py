"""Two-stage retrieval, the port of ``fedrec_tpu/serving/retrieval.py``:
k-means coarse quantizer + exact rerank, with the exact scorer below
``exact_threshold``.

Full-catalog scoring is one ``(B, D) x (D, N)`` product per batch. Past
the scale where that stops being cheap, the index clusters the news
vectors once per generation (Lloyd's k-means), and at query time scores
the user against the C centroids, probes the ``n_probe`` best clusters and
exactly reranks only their members; recall is measured against brute
force by :func:`recall_at_k`.

The member table is a fixed ``(C, M)`` -1-padded matrix, as in the JAX
package. Where JAX materialises the ``(B, n_probe*M, D)`` candidate vectors
and a ``(B, n_probe*M, H)`` history compare, the port computes the same
scores in column blocks under ``_RERANK_BYTES`` and tests history
membership by a per-row binary search. The k-means products, the probe and
the rerank are plain PyTorch (``torch.matmul``, a product and sum,
``torch.topk``), as the JAX package leaves them to XLA; the user tower is
kernel B under ``model.fuse_hot_path``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from fedrec_tpu_torch.device import resolve_device
from fedrec_tpu_torch.serve import _NEG, build_recommend_fn
from fedrec_tpu_torch.train.step import take_rows_backward

# bytes of gathered candidate vectors one rerank block may hold (its
# products take as much again), and of the (rows, C) distance block of a
# k-means assignment
_RERANK_BYTES = 1 << 29


def _assign(vecs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every row, ``argmin ||x - c||^2 = argmin
    (||c||^2 / 2 - x.c)``: one f32 product per row block of at most
    ``_RERANK_BYTES`` of distances (the first minimum wins a tie)."""
    half_sq = 0.5 * (cents * cents).sum(1)
    rows = max(1, _RERANK_BYTES // (4 * cents.shape[0]))
    return torch.cat([
        torch.argmin(half_sq[None, :] - block @ cents.T, dim=1)
        for block in vecs.split(rows)
    ])


def _lloyd(
    vecs: torch.Tensor, init_centroids: torch.Tensor, iters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from ``init_centroids`` (C, D); returns
    ``(centroids (C, D) float32, assign (N,) int32)``. Empty clusters keep
    their centroid. Each cluster's sum runs over its members in row order
    (a stable sort, then ``segment_reduce``; no atomics), so a repeat gives
    bitwise the same centroids on the CPU and the GPU. The assignment
    returned is recomputed against the final centroids: the last step's
    predates the last update, and a member table inconsistent with the
    probing centroids silently costs recall."""
    vecs = vecs.float()
    cents = init_centroids.float().clone()
    c = cents.shape[0]
    for _ in range(iters):
        assign = _assign(vecs, cents)
        sums = take_rows_backward(vecs, assign, c)
        counts = torch.bincount(assign, minlength=c).to(torch.float32)
        cents = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], cents)
    return cents, _assign(vecs, cents).to(torch.int32)


def kmeans(
    vecs: torch.Tensor,
    num_clusters: int,
    iters: int = 10,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means over (N, D) vectors on ``device`` (default ``cuda``,
    which raises without a GPU). Init is a no-replacement sample of
    ``num_clusters`` rows drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (other rows than ``jax.random.choice`` picks for the same
    seed); :func:`_lloyd` does the rest."""
    dev = resolve_device(device)
    vecs = torch.as_tensor(vecs).to(dev, torch.float32)
    n = vecs.shape[0]
    c = min(int(num_clusters), n)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:c]
    return _lloyd(vecs, vecs[rows.to(dev)], iters)


@dataclass(frozen=True)
class TwoStageIndex:
    """Immutable per-generation retrieval structure.

    ``exact=True`` means no coarse stage (the full product wins);
    ``centroids`` and ``members`` are None then. ``members`` is the (C, M)
    cluster-membership matrix, -1-padded to the largest cluster's size:
    fixed shapes at the cost of gathering (and masking) padding for skewed
    clusterings.
    """

    news_vecs: Any                    # (N, D)
    valid_mask: np.ndarray | None     # (N,) bool
    exact: bool
    centroids: Any = None             # (C, D) float32
    members: Any = None               # (C, M) int64, -1-padded
    n_probe: int = 0

    @property
    def num_news(self) -> int:
        return int(self.news_vecs.shape[0])

    def stats(self) -> dict:
        if self.exact:
            return {"exact": True, "num_news": self.num_news}
        c, m = self.members.shape
        scanned = min(self.n_probe, c) * m
        return {
            "exact": False,
            "num_news": self.num_news,
            "num_clusters": int(c),
            "max_cluster_size": int(m),
            "n_probe": int(self.n_probe),
            # worst-case fraction of the catalog touched per request
            "scan_fraction": round(scanned / max(self.num_news, 1), 4),
        }


def member_table(assign: np.ndarray, num_clusters: int,
                 valid_mask: np.ndarray | None = None) -> np.ndarray:
    """The (C, M) -1-padded member table of an assignment: id 0 (the pad
    slot) and invalid rows dropped, ids ascending within a cluster, M the
    largest cluster (at least 1). One stable sort, not a pass per
    cluster."""
    assign = np.asarray(assign)
    keep = np.arange(assign.shape[0]) != 0
    if valid_mask is not None:
        keep &= np.asarray(valid_mask, bool)
    ids = np.flatnonzero(keep)
    cluster = assign[ids]
    order = np.argsort(cluster, kind="stable")
    ids, cluster = ids[order], cluster[order]
    counts = np.bincount(cluster, minlength=num_clusters)
    starts = np.cumsum(counts) - counts
    members = np.full((num_clusters, max(1, int(counts.max(initial=0)))), -1, np.int64)
    members[cluster, np.arange(ids.shape[0]) - starts[cluster]] = ids
    return members


def build_index(
    news_vecs,
    num_clusters: int = 0,
    n_probe: int = 8,
    iters: int = 10,
    seed: int = 0,
    valid_mask: np.ndarray | None = None,
    exact_threshold: int = 4096,
    device: str | torch.device | None = None,
) -> TwoStageIndex:
    """Build the per-generation index on ``device`` (default ``cuda``).
    ``num_clusters <= 1`` or a catalog at/below ``exact_threshold`` selects
    the exact path: the coarse stage only pays once the full product stops
    being the cheap option."""
    n = int(news_vecs.shape[0])
    if num_clusters <= 1 or n <= exact_threshold:
        return TwoStageIndex(news_vecs=news_vecs, valid_mask=valid_mask, exact=True)
    dev = resolve_device(device)
    cents, assign = kmeans(news_vecs, num_clusters, iters=iters, seed=seed, device=dev)
    members = member_table(assign.cpu().numpy(), cents.shape[0], valid_mask)
    return TwoStageIndex(
        news_vecs=news_vecs,
        valid_mask=valid_mask,
        exact=False,
        centroids=cents,
        members=torch.from_numpy(members).to(dev),
        n_probe=int(n_probe),
    )


def _in_history(cand_ids: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """``(cand_ids[:, :, None] == history[:, None, :]).any(-1)`` without the
    H-wide broadcast: a binary search of each candidate in its row's sorted
    history."""
    hist = torch.sort(history, dim=1).values
    pos = torch.searchsorted(hist, cand_ids).clamp(max=hist.shape[1] - 1)
    return hist.gather(1, pos) == cand_ids


def rerank_scores(user_vec: torch.Tensor, news_vecs: torch.Tensor,
                  cand_ids: torch.Tensor) -> torch.Tensor:
    """``scores[b, j] = user_vec[b] . news_vecs[cand_ids[b, j]]`` in f32
    (ids clamped into range; the caller masks the padding), one column block
    of at most ``_RERANK_BYTES`` of gathered vectors at a time. Each score
    is a product and a sum over the last dimension, whose order does not
    depend on the block's shape, so the blocking never changes a bit (a
    batched product would pick its routine by shape)."""
    b, width = cand_ids.shape
    n, d = news_vecs.shape
    safe = cand_ids.clamp(0, n - 1)
    cols = max(1, _RERANK_BYTES // (4 * d * max(b, 1)))
    u = user_vec.float()[:, None, :]
    out = torch.empty((b, width), dtype=torch.float32, device=user_vec.device)
    for start in range(0, width, cols):
        block = news_vecs[safe[:, start:start + cols]].float()        # (B, cols, D)
        out[:, start:start + cols] = (block * u).sum(-1)
    return out


def build_two_stage_fn(
    index: TwoStageIndex,
    top_k: int = 10,
    exclude_history: bool = True,
    device: str | torch.device | None = None,
) -> Callable:
    """``retrieve(user_tower, history) -> (ids, scores)`` over the index's
    table on ``device`` (default ``cuda``, which raises without a GPU): the
    contract of ``serve.build_recommend_fn`` minus the table argument.

    Exact indexes delegate to the dense scorer; two-stage ones run probe ->
    member gather -> exact f32 rerank. Tail slots past the valid
    candidates carry id -1 and the float32-min score, as the dense path's.
    """
    if index.exact:
        base = build_recommend_fn(
            top_k=top_k,
            exclude_history=exclude_history,
            valid_mask=index.valid_mask,
            device=device,
        )
        table = index.news_vecs

        def retrieve_exact(user_tower, history):
            return base(user_tower, table, history)

        return retrieve_exact

    dev = resolve_device(device)
    news_vecs, centroids, members = index.news_vecs, index.centroids, index.members
    n = news_vecs.shape[0]
    n_probe = min(index.n_probe, members.shape[0])
    k = min(top_k, n_probe * members.shape[1])

    @torch.no_grad()
    def retrieve(user_tower, history):
        history = torch.as_tensor(history).to(dev, torch.long)
        # the same clamp as the exact scorer: degenerate ids behave alike
        his_vecs = news_vecs[history.clamp(0, n - 1)]
        user_vec = user_tower(his_vecs).float()                        # (B, D)
        b = history.shape[0]
        top_c = torch.topk(user_vec @ centroids.T, n_probe, dim=1).indices
        cand_ids = members[top_c].reshape(b, -1)                       # (B, n_probe*M)
        scores = rerank_scores(user_vec, news_vecs, cand_ids)
        invalid = cand_ids < 0                                         # member padding
        if exclude_history:
            # clusters partition the ids, so candidates never repeat
            invalid |= _in_history(cand_ids, history)
        scores = scores.masked_fill(invalid, _NEG)
        top_scores, pick = torch.topk(scores, k, dim=1)
        top_ids = cand_ids.gather(1, pick)
        top_ids = torch.where(top_scores <= _NEG, -1, top_ids)
        return top_ids.to(torch.int32), top_scores

    return retrieve


def recall_at_k(
    index: TwoStageIndex,
    user_tower,
    histories,
    k: int = 10,
    exclude_history: bool = True,
    device: str | torch.device | None = None,
) -> float:
    """Measured recall@k of the two-stage path against brute force on the
    same generation: the mean over queries of ``|approx top-k & exact
    top-k| / |exact top-k|``."""
    exact = build_recommend_fn(top_k=k, exclude_history=exclude_history,
                               valid_mask=index.valid_mask, device=device)
    approx = build_two_stage_fn(index, top_k=k, exclude_history=exclude_history, device=device)
    ids_e = exact(user_tower, index.news_vecs, histories)[0].cpu().numpy()
    ids_a = approx(user_tower, histories)[0].cpu().numpy()
    hits, total = 0, 0
    for row_e, row_a in zip(ids_e, ids_a):
        truth = set(int(i) for i in row_e if i >= 0)
        if not truth:
            continue
        got = set(int(i) for i in row_a if i >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0
