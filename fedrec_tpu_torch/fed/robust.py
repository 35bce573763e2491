"""Byzantine-robust round-end aggregation, the port of ``fedrec_tpu/fed/robust.py``.

``fed.robust.method`` picks the aggregator:

* ``mean``         — the participation-weighted FedAvg
  (``strategies.weighted_param_avg``), the default, bitwise unchanged;
* ``clip``         — each client's deviation from the coordinate-wise cohort
  median is clipped to ``clip_norm`` in one global L2 over every leaf given
  (pass both towers together), then weighted-mean'd around the median; a
  non-finite contribution clips to exactly zero;
* ``trimmed_mean`` — coordinate-wise: among the finite participant values,
  drop the ``trim_k`` largest and smallest and take the unweighted mean of
  the rest (``trim_k`` clamped per coordinate so one value is always kept);
* ``median``       — the coordinate-wise median of the finite participant
  values.

The JAX package gathers the cohort inside ``shard_map``. Here each
client's leaves are flattened into one row of a (K, P) stack on the device
and sorted along the client axis: every output element has one owner and
one summation order (a sum over the K sorted values), so a result repeats
to the bit. Non-participants (weight 0) are left out of every method, so a
quarantined client whose parameters are NaN contributes nothing. A round
with no participant keeps each client's local parameters.

``robust_reduce_np`` and ``robust_reduce_tree_np`` are the host variants
the coordinator's gather and the hierarchical reduce use: numpy over (P,
...) stacks of per-process contributions in f64, the JAX package's
arithmetic line for line (NaN cells and weight-0 rows left out, an m == 0
coordinate keeps the fallback, ``clip`` on the deviation norm over every
leaf).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from fedrec_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

if TYPE_CHECKING:
    import torch

ROBUST_METHODS = ("mean", "clip", "trimmed_mean", "median")


def validate_robust_method(method: str) -> str:
    if method not in ROBUST_METHODS:
        raise ValueError(
            f"unknown fed.robust.method {method!r}; expected one of "
            f"{ROBUST_METHODS}"
        )
    return method


def _client_axis(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) tensor shaped to broadcast over a (K, ...) stack."""
    return t.reshape((-1,) + (1,) * (like.dim() - 1))


def _sorted_participants(stacked: torch.Tensor, wmask: torch.Tensor):
    """The (K, ...) stack sorted along the client axis with the finite
    participant values first, ascending, and every other cell (dropouts,
    quarantined clients, NaN/inf) replaced by +inf at the end; and the
    per-coordinate count of finite participant values."""
    import torch

    finite = torch.isfinite(stacked) & (_client_axis(wmask, stacked) > 0)
    vals = torch.where(finite, stacked, torch.full_like(stacked, float("inf")))
    return torch.sort(vals, dim=0).values, finite.sum(0, dtype=torch.int32)


def trimmed_mean(stacked: torch.Tensor, wmask: torch.Tensor, trim_k: int):
    """Coordinate-wise trimmed mean of a (K, ...) stack -> ``(mean, m)``,
    ``m`` the per-coordinate count of finite participant values."""
    import torch

    srt, m = _sorted_participants(stacked, wmask)
    pos = _client_axis(torch.arange(srt.shape[0], device=srt.device), srt)
    k = torch.clamp((m - 1) // 2, max=trim_k)
    keep = (pos >= k) & (pos < m - k)
    denom = torch.clamp(m - 2 * k, min=1).to(srt.dtype)
    return torch.where(keep, srt, torch.zeros_like(srt)).sum(0) / denom, m


def median(stacked: torch.Tensor, wmask: torch.Tensor):
    """Coordinate-wise median of the finite participant values of a
    (K, ...) stack -> ``(median, m)``; 0 where ``m == 0``."""
    import torch

    srt, m = _sorted_participants(stacked, wmask)
    safe = torch.where(torch.isfinite(srt), srt, torch.zeros_like(srt))
    lo = ((m - 1) // 2).clamp(min=0).long().unsqueeze(0)
    hi = (m // 2).clamp(max=srt.shape[0] - 1).long().unsqueeze(0)
    return 0.5 * (safe.gather(0, lo)[0] + safe.gather(0, hi)[0]), m


def clip(stacked: torch.Tensor, weights: torch.Tensor, wmask: torch.Tensor,
         clip_norm: float) -> torch.Tensor:
    """The centred clipped mean of a (K, P) stack: each client's deviation
    from the coordinate-wise median, its L2 over the whole row scaled to at
    most ``clip_norm`` (to 0 when not finite), then the weighted mean of the
    scaled deviations added to the median."""
    import torch

    center = median(stacked, wmask)[0]
    d = stacked - center[None]
    # a non-finite deviation poisons the norm on purpose: the client's
    # whole contribution then scales to zero
    norm = torch.sqrt(d.float().square().sum(1))
    scale = torch.where(torch.isfinite(norm),
                        torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0),
                        torch.zeros_like(norm))
    total = (weights * wmask).sum()
    coeff = (weights * wmask * scale).to(stacked.dtype)
    safe = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return center + (coeff[:, None] * safe).sum(0) / torch.clamp(total, min=1e-12).to(d.dtype)


def robust_aggregate(params: Sequence[Sequence[torch.Tensor]], weights, method: str,
                     trim_k: int = 1, clip_norm: float = 10.0) -> list[list[torch.Tensor]]:
    """Robust round-end aggregation over the K clients.

    ``params`` holds each client's leaves in one fixed order (pass both
    towers as one list, so that ``clip``'s global norm spans the whole
    update); ``weights`` one round weight per client (0 = dropped out or
    quarantined). Returns each client's new leaves: every client, the
    non-participants included, adopts the aggregate, except where a
    coordinate has no finite participant value (trimmed mean, median) or
    no client reports at all, which keep the local value.
    """
    import torch

    from fedrec_tpu_torch.fed.strategies import weighted_param_avg

    validate_robust_method(method)
    w_np = np.asarray(weights, dtype=np.float32).reshape(-1)
    if w_np.shape[0] != len(params):
        raise ValueError(f"{w_np.shape[0]} weights for {len(params)} clients")
    if method == "mean":
        return weighted_param_avg(params, w_np)
    if not (w_np > 0).any():
        return [list(p) for p in params]
    dev = params[0][0].device
    w = torch.from_numpy(w_np).to(dev)
    wmask = (w > 0).to(torch.float32)
    # every leaf of a client in one row, (K, P): each method is per
    # coordinate (clip's norm spans every leaf anyway), and one row a
    # client costs a few launches where a stack a leaf costs hundreds
    shapes = [t.shape for t in params[0]]
    stacked = torch.stack([torch.cat([t.reshape(-1) for t in p]) for p in params])
    if method == "clip":
        rows = clip(stacked, w, wmask, clip_norm).expand(len(params), -1)
    else:
        agg, m = (trimmed_mean(stacked, wmask, trim_k) if method == "trimmed_mean"
                  else median(stacked, wmask))
        # a coordinate no finite participant reported keeps the local value
        rows = torch.where(m > 0, agg.to(stacked.dtype), stacked)
    sizes = [math.prod(s) for s in shapes]
    return [[t.view(s) for t, s in zip(row.split(sizes), shapes)] for row in rows]


# ----------------------------------------------------------------- numpy
def robust_reduce_np(
    stacked: np.ndarray,
    weights: np.ndarray,
    method: str,
    trim_k: int = 1,
    clip_norm: float = 10.0,
    sq_norms: np.ndarray | None = None,
    fallback: np.ndarray | None = None,
) -> np.ndarray:
    """Robust reduction over a (P, ...) stack of per-process contributions,
    in f64: participation is ``weights > 0``, non-finite cells are left
    out, trimming and the median are per coordinate, and a coordinate with
    no finite participant (m == 0) keeps ``fallback`` (0.0 without one).
    ``clip`` needs the per-process deviation norm over every leaf
    (``sq_norms``, from :func:`robust_reduce_tree_np`); without it the leaf
    is clipped by its own norm."""
    validate_robust_method(method)
    w = np.asarray(weights, np.float64)
    x = np.asarray(stacked, np.float64)
    wmask = (w > 0).reshape((-1,) + (1,) * (x.ndim - 1))
    if method == "mean":
        total = float(np.sum(w))
        if total == 0:
            raise ValueError("mean reduction needs >= 1 participant")
        contrib = np.where(wmask > 0, x, 0.0)
        return np.einsum("p,p...->...", w, contrib) / total

    finite = np.isfinite(x) & (wmask > 0)
    vals = np.where(finite, x, np.inf)
    srt = np.sort(vals, axis=0)
    m = finite.sum(axis=0)
    pos = np.arange(x.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
    fb = 0.0 if fallback is None else np.asarray(fallback, np.float64)
    if method == "trimmed_mean":
        k = np.minimum(trim_k, (m - 1) // 2)
        keep = (pos >= k) & (pos < m - k)
        denom = np.maximum(m - 2 * k, 1)
        out = np.where(keep, np.where(np.isfinite(srt), srt, 0.0), 0.0).sum(0)
        return np.where(m > 0, out / denom, fb)
    lo, hi = (m - 1) // 2, m // 2
    safe = np.where(np.isfinite(srt), srt, 0.0)
    mid = 0.5 * (np.where(pos == lo, safe, 0.0).sum(0) + np.where(pos == hi, safe, 0.0).sum(0))
    if method == "median":
        return np.where(m > 0, mid, fb)
    # clip, around the coordinate-wise median
    d = x - mid[None]
    if sq_norms is None:
        sq_norms = _sq_deviation(d)
    norm = np.sqrt(sq_norms)
    scale = np.where(np.isfinite(norm), np.minimum(1.0, clip_norm / np.maximum(norm, 1e-12)), 0.0)
    coeff = w * (w > 0) * scale
    total = float(np.sum(w * (w > 0)))
    if total == 0:
        raise ValueError("clip reduction needs >= 1 participant")
    safe_d = np.where(np.isfinite(d), d, 0.0)
    return mid + np.einsum("p,p...->...", coeff, safe_d) / total


def _sq_deviation(d: np.ndarray) -> np.ndarray:
    """Each row's squared L2 norm over its finite cells; inf for a row
    with a non-finite cell."""
    d_flat = d.reshape(d.shape[0], -1)
    finite_rows = np.isfinite(d_flat).all(axis=1)
    return np.where(finite_rows, (np.where(np.isfinite(d_flat), d_flat, 0.0) ** 2).sum(axis=1),
                    np.inf)


def robust_reduce_tree_np(
    gathered_tree: Any,
    weights: np.ndarray,
    method: str,
    trim_k: int = 1,
    clip_norm: float = 10.0,
    fallback_tree: Any = None,
) -> Any:
    """:func:`robust_reduce_np` over every leaf of a tree of (P, ...)
    stacks. ``clip``'s per-process deviation norm spans all leaves;
    ``fallback_tree`` (unstacked, the caller's local values) fills the m ==
    0 coordinates."""
    validate_robust_method(method)
    leaves, treedef = tree_flatten(gathered_tree)
    leaves = [np.asarray(leaf, np.float64) for leaf in leaves]
    fb_leaves: list = [None] * len(leaves)
    if fallback_tree is not None:
        fb_leaves = tree_flatten(fallback_tree)[0]
    if method != "clip":
        return tree_unflatten(treedef, [
            robust_reduce_np(leaf, weights, method, trim_k=trim_k, fallback=fb)
            for leaf, fb in zip(leaves, fb_leaves)])
    n = leaves[0].shape[0]
    w = np.asarray(weights, np.float64)
    sq = np.zeros((n,), np.float64)
    for x in leaves:
        center = robust_reduce_np(x, w, "median")
        sq = sq + _sq_deviation(x - center[None])
    return tree_unflatten(treedef, [
        robust_reduce_np(leaf, weights, "clip", clip_norm=clip_norm, sq_norms=sq)
        for leaf in leaves])
