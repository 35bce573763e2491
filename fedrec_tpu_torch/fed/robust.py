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

``robust_reduce_np``, the coordinator's host variant, is not ported (it
comes with the multi-process deployment, ``ROADMAP.md`` Queue A item 9).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
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
    finite = torch.isfinite(stacked) & (_client_axis(wmask, stacked) > 0)
    vals = torch.where(finite, stacked, torch.full_like(stacked, float("inf")))
    return torch.sort(vals, dim=0).values, finite.sum(0, dtype=torch.int32)


def trimmed_mean(stacked: torch.Tensor, wmask: torch.Tensor, trim_k: int):
    """Coordinate-wise trimmed mean of a (K, ...) stack -> ``(mean, m)``,
    ``m`` the per-coordinate count of finite participant values."""
    srt, m = _sorted_participants(stacked, wmask)
    pos = _client_axis(torch.arange(srt.shape[0], device=srt.device), srt)
    k = torch.clamp((m - 1) // 2, max=trim_k)
    keep = (pos >= k) & (pos < m - k)
    denom = torch.clamp(m - 2 * k, min=1).to(srt.dtype)
    return torch.where(keep, srt, torch.zeros_like(srt)).sum(0) / denom, m


def median(stacked: torch.Tensor, wmask: torch.Tensor):
    """Coordinate-wise median of the finite participant values of a
    (K, ...) stack -> ``(median, m)``; 0 where ``m == 0``."""
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
