"""Batched top-k recommendation over the news table, the port of
``fedrec_tpu/serve.py``'s exact scorer.

``recommend(user_tower, news_vecs, history)`` gathers the clicked-news
vectors, encodes the user (kernel B under ``model.fuse_hot_path``), scores
the whole catalog with one f32 ``(B, D) x (D, N)`` product, masks the pad
id 0, invalid rows and (by default) the history, and takes the top k. The
user tower module plays the part of the JAX function's ``user_params``
(it holds its own weights, so the JAX ``model`` argument has no
counterpart here). The catalog product and the top k are plain
``torch.matmul`` / ``torch.topk``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Callable

import torch

from fedrec_tpu_torch.device import resolve_device

_NEG = torch.finfo(torch.float32).min


def _exclude_ids(invalid: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Mark ``ids`` (B, H) invalid in the (B, n) mask; ids outside
    ``[0, n)`` are no-ops. Plain tensor indexing would wrap a negative id
    onto item ``n - |id|``, so ids are clamped and only in-range ones count;
    the marks are summed (not assigned) so duplicate indices cannot race."""
    in_range = (ids >= 0) & (ids < n)
    safe = ids.clamp(0, n - 1)
    hits = torch.zeros(invalid.shape, dtype=torch.int32, device=invalid.device)
    hits.scatter_add_(1, safe, in_range.to(torch.int32))
    return invalid | (hits > 0)


def build_recommend_fn(
    top_k: int = 10,
    exclude_history: bool = True,
    valid_mask: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> Callable:
    """Return ``recommend(user_tower, news_vecs, history) -> (ids, scores)``.

    ``history``: (B, H) integer clicked-news ids, 0-padded; the gather that
    feeds the user tower clamps them into ``[0, N)``, the exclusion mask
    ignores ids outside it. Returns ``ids`` (B, k) int32 and ``scores``
    (B, k) float32, best first, with ``k = min(top_k, N)``; when fewer than
    k valid items exist the tail slots hold id -1 and the float32-min score.
    ``valid_mask``: optional (N,) bool, False rows are never recommended.
    ``device``: where the scorer runs (default ``cuda``, which raises
    without a GPU); ``news_vecs`` and the user tower must live there.
    """
    dev = resolve_device(device)
    if valid_mask is not None:
        valid_mask = torch.as_tensor(valid_mask, dtype=torch.bool).to(dev)

    @torch.no_grad()
    def recommend(user_tower, news_vecs: torch.Tensor, history):
        if news_vecs.device.type != dev.type:
            raise ValueError(f"news_vecs live on {news_vecs.device}, the scorer runs on {dev}")
        history = torch.as_tensor(history).to(dev, torch.long)
        n = news_vecs.shape[0]
        his_vecs = news_vecs[history.clamp(0, n - 1)]          # (B, H, D)
        user_vec = user_tower(his_vecs)                         # (B, D)
        scores = user_vec.float() @ news_vecs.float().T        # (B, N) f32
        invalid = torch.zeros((history.shape[0], n), dtype=torch.bool, device=dev)
        invalid[:, 0] = True
        if valid_mask is not None:
            invalid |= ~valid_mask[None, :]
        if exclude_history:
            invalid = _exclude_ids(invalid, history, n)
        scores = scores.masked_fill(invalid, _NEG)
        top_scores, top_ids = torch.topk(scores, min(top_k, n), dim=1)
        top_ids = torch.where(top_scores <= _NEG, -1, top_ids)
        return top_ids.to(torch.int32), top_scores

    return recommend
