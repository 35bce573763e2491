"""Hierarchical (tiered) robust reduction, ``agg.mode="hierarchical"``, the
port of ``fedrec_tpu/agg/hierarchy.py``.

The P contributions are grouped into ``agg.tree_fanout``-wide tiers in
rank order, each tier is pre-aggregated with the ``fed.robust`` method
(``fed.robust.robust_reduce_tree_np``), and the tier outputs reduce up the
tree. A tier's weight at the next level is its group's summed weight; an
all-zero group carries the fallback at weight 0. Groups of one level are
independent, so a deployment's reduce costs the slowest group per level,
summed over the levels (:func:`tree_critical_path_ms`).

Under ``mean`` the tiers carry ``(sum(w x), sum(w))`` partial sums and one
divide at the root: algebraically the flat weighted mean, so the trainer
and the coordinator never route ``mean`` here (it lowers to the flat
reduce, bit for bit). Any other method trims or takes medians of tier
pre-aggregates and diverges from the flat reduce by design.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from fedrec_tpu_torch.fed.robust import robust_reduce_tree_np, validate_robust_method
from fedrec_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

__all__ = ["build_tree", "tree_critical_path_ms", "tree_reduce_np"]


def build_tree(count: int, fanout: int) -> list[list[list[int]]]:
    """The reduce tree over ``count`` rank-ordered members: one list of
    groups per level, each group indices into the previous level's
    outputs. ``count <= fanout`` is one group; ``count == 1`` one trivial
    level."""
    if count < 1:
        raise ValueError(f"reduce tree needs >= 1 member, got {count}")
    if fanout < 2:
        raise ValueError(f"agg.tree_fanout must be >= 2, got {fanout}")
    levels: list[list[list[int]]] = []
    cur = count
    while cur > 1:
        groups = [list(range(i, min(i + fanout, cur))) for i in range(0, cur, fanout)]
        levels.append(groups)
        cur = len(groups)
    if not levels:
        levels.append([[0]])
    return levels


def tree_critical_path_ms(stats: dict) -> float:
    """The slowest group of each level, summed over the levels."""
    return float(sum(lv["max_group_ms"] for lv in stats.get("levels", [])))


def tree_reduce_np(
    gathered_tree: Any,
    weights: np.ndarray,
    fanout: int,
    method: str,
    trim_k: int = 1,
    clip_norm: float = 10.0,
    fallback_tree: Any = None,
    stats: dict | None = None,
) -> Any:
    """Tiered reduction of a tree of (P, ...) stacks; ``stats`` (out)
    receives each level's group count and times."""
    validate_robust_method(method)
    leaves, treedef = tree_flatten(gathered_tree)
    stacks = [np.asarray(leaf, np.float64) for leaf in leaves]
    count = stacks[0].shape[0]
    w = np.asarray(weights, np.float64)
    if w.shape[0] != count:
        raise ValueError(f"weights {w.shape} do not match stack P={count}")
    fb_leaves: list = [None] * len(stacks)
    if fallback_tree is not None:
        fb_leaves = tree_flatten(fallback_tree)[0]
    if stats is not None:
        stats.setdefault("levels", [])
        stats["members"] = int(count)
        stats["fanout"] = int(fanout)

    if method == "mean":
        return tree_unflatten(treedef, _mean_tree(stacks, w, fanout, stats))

    for groups in build_tree(count, fanout):
        next_stacks: list[list[np.ndarray]] = [[] for _ in stacks]
        next_w = np.zeros((len(groups),), np.float64)
        group_ms: list[float] = []
        for gi, idxs in enumerate(groups):
            t0 = time.monotonic()
            sub_w = w[idxs]
            next_w[gi] = float(np.sum(sub_w * (sub_w > 0)))
            if next_w[gi] == 0.0:
                # no participant in the tier: the fallback, masked out by
                # its weight 0 one level up
                for li, fb in enumerate(fb_leaves):
                    next_stacks[li].append(np.asarray(fb, np.float64) if fb is not None
                                           else np.zeros(stacks[li].shape[1:], np.float64))
                group_ms.append((time.monotonic() - t0) * 1e3)
                continue
            reduced = robust_reduce_tree_np(
                tree_unflatten(treedef, [s[idxs] for s in stacks]), sub_w, method,
                trim_k=trim_k, clip_norm=clip_norm, fallback_tree=fallback_tree)
            for li, leaf in enumerate(tree_flatten(reduced)[0]):
                next_stacks[li].append(np.asarray(leaf, np.float64))
            group_ms.append((time.monotonic() - t0) * 1e3)
        stacks = [np.stack(cells, axis=0) for cells in next_stacks]
        w = next_w
        if stats is not None:
            stats["levels"].append({"groups": len(groups),
                                    "max_group_ms": max(group_ms) if group_ms else 0.0,
                                    "total_ms": float(sum(group_ms))})
    return tree_unflatten(treedef, [s[0] for s in stacks])


def _mean_tree(stacks: list[np.ndarray], w: np.ndarray, fanout: int,
               stats: dict | None) -> list[np.ndarray]:
    """The partial-sum lowering of ``mean``: tiers carry ``(sum(w x),
    sum(w))`` and the root divides once."""
    total = float(np.sum(w * (w > 0)))
    if total == 0:
        raise ValueError("mean reduction needs >= 1 participant")
    wmask = w > 0
    partials = [np.einsum("p,p...->p...", w * wmask,
                          np.where(wmask.reshape((-1,) + (1,) * (s.ndim - 1)), s, 0.0))
                for s in stacks]
    for groups in build_tree(partials[0].shape[0], fanout):
        group_ms: list[float] = []
        next_partials: list[list[np.ndarray]] = [[] for _ in partials]
        for idxs in groups:
            t0 = time.monotonic()
            for li, p in enumerate(partials):
                next_partials[li].append(p[idxs].sum(axis=0))
            group_ms.append((time.monotonic() - t0) * 1e3)
        partials = [np.stack(cells, axis=0) for cells in next_partials]
        if stats is not None:
            stats["levels"].append({"groups": len(groups),
                                    "max_group_ms": max(group_ms) if group_ms else 0.0,
                                    "total_ms": float(sum(group_ms))})
    return [p[0] / total for p in partials]
