"""Retrieval index, the port of ``fedrec_tpu/serving/retrieval.py``: the
exact branch only. A k-means two-stage index (``num_clusters > 1`` above
``exact_threshold``) is not ported yet and raises."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from fedrec_tpu_torch.serve import build_recommend_fn


@dataclass(frozen=True)
class TwoStageIndex:
    """Immutable per-generation retrieval structure (exact only here)."""

    news_vecs: Any                    # (N, D)
    valid_mask: np.ndarray | None     # (N,) bool


def build_index(
    news_vecs,
    num_clusters: int = 0,
    valid_mask: np.ndarray | None = None,
    exact_threshold: int = 4096,
) -> TwoStageIndex:
    """``num_clusters <= 1`` or a catalog at/below ``exact_threshold``
    selects the exact path; anything else needs the k-means index."""
    n = int(news_vecs.shape[0])
    if num_clusters <= 1 or n <= exact_threshold:
        return TwoStageIndex(news_vecs=news_vecs, valid_mask=valid_mask)
    raise NotImplementedError(
        f"k-means retrieval not yet ported (num_clusters={num_clusters}, "
        f"catalog {n} > exact_threshold {exact_threshold}); serve with --clusters 0"
    )


def build_two_stage_fn(
    index: TwoStageIndex,
    top_k: int = 10,
    exclude_history: bool = True,
    device=None,
) -> Callable:
    """``retrieve(user_tower, history) -> (ids, scores)`` over the index's
    table: the exact scorer bound to this generation's arrays, run on
    ``device`` (default ``cuda``)."""
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
