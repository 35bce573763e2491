"""Ranking metrics, the port of ``fedrec_tpu/eval/metrics.py``: AUC / MRR /
NDCG on the host (numpy copies, the same semantics) and on the device
(torch tensors, the same closed forms).

Semantics match the reference ``evaluation_functions.py:5-47`` (DCG with
``2**rel - 1`` gains and log2 discounts, MRR normalized by the positive count,
binary AUC) with the JAX package's two deliberate divergences: AUC is the
Mann-Whitney U with average ranks on ties (no sklearn), and a validation set
aggregates as the mean over impressions.

The device functions assume the reference's fixed impression layout, one
positive at slot 0 and sampled negatives (or a masked full pool), which makes
every metric a closed form of the positive's rank: comparisons and sums, no
sort. ``quality_stats_batch``'s histograms are a one-hot product summed over
rows, as in JAX: fixed shapes and a fixed sum order, so the sums repeat to
the bit on the card (``torch.bincount`` with weights and a float
``index_add_`` accumulate with atomics there, and would not).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# host-side (numpy) — API parity with reference evaluation_functions.py
# --------------------------------------------------------------------------


def dcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    """DCG@k with (2**rel - 1) gains (reference ``evaluation_functions.py:5-10``)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(y_score)[::-1]
    taken = np.take(y_true, order[:k])
    gains = 2.0**taken - 1.0
    discounts = np.log2(np.arange(len(taken)) + 2.0)
    return float(np.sum(gains / discounts))


def ndcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    """NDCG@k (reference ``evaluation_functions.py:13-16``)."""
    best = dcg_score(y_true, y_true, k)
    actual = dcg_score(y_true, y_score, k)
    return actual / best


def mrr_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Mean reciprocal rank over positives (reference ``evaluation_functions.py:19-23``)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(y_score)[::-1]
    ranked = np.take(y_true, order)
    rr = ranked / (np.arange(len(ranked)) + 1.0)
    return float(np.sum(rr) / np.sum(y_true))


def auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ROC-AUC via the Mann-Whitney U statistic with average ranks
    (equal to ``sklearn.metrics.roc_auc_score`` for binary labels). Raises
    ``ValueError`` unless both classes are present."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = float(np.sum(y_true == 1))
    n_neg = float(np.sum(y_true == 0))
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined: need at least one positive and one negative")
    # average ranks (1-based) with tie correction
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(y_score) + 1, dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    rank_sum_pos = float(np.sum(ranks[y_true == 1]))
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)


def safe_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """:func:`auc_score`, with NaN instead of ``ValueError`` when the labels
    hold one class (a stratum of a sliced analysis may be all-positive)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    if np.sum(y_true == 1) == 0 or np.sum(y_true == 0) == 0:
        return float("nan")
    return auc_score(y_true, y_score)


def compute_amn(y_true: np.ndarray, y_score: np.ndarray) -> tuple[float, float, float, float]:
    """(AUC, MRR, NDCG@5, NDCG@10) — reference ``evaluation_functions.py:26-31``."""
    return (
        auc_score(y_true, y_score),
        mrr_score(y_true, y_score),
        ndcg_score(y_true, y_score, 5),
        ndcg_score(y_true, y_score, 10),
    )


def evaluation_split(
    news_vecs: np.ndarray,
    user_vecs: np.ndarray,
    samples: list,
    nid2index: dict,
) -> np.ndarray:
    """Offline split evaluation (reference ``evaluation_functions.py:33-47``):
    an (n_valid, 4) array of per-impression (AUC, MRR, NDCG@5, NDCG@10) from
    ``news_vec . user_vec`` over positives + negatives. Impressions whose
    metrics are undefined (no negatives) are skipped, as the reference's
    try/except does."""
    results = []
    for i, sample in enumerate(samples):
        _, poss, negs, _, _ = sample
        if isinstance(poss, str):
            poss = [poss]
        user_vec = user_vecs[i]
        y_true = np.array([1] * len(poss) + [0] * len(negs))
        news_ids = [nid2index[n] for n in list(poss) + list(negs)]
        scores = news_vecs[news_ids] @ user_vec
        try:
            results.append(compute_amn(y_true, scores))
        except ValueError:
            continue
    return np.array(results)


# --------------------------------------------------------------------------
# device-side (torch) — closed forms for the fixed 1-pos + K-neg layout
# --------------------------------------------------------------------------


def _metrics_from_rank(rank: torch.Tensor) -> dict:
    """MRR/NDCG@5/NDCG@10 from the positive's 1-based rank (one positive,
    ideal DCG = 1). AUC differs between the fixed-C and masked-pool layouts,
    so each caller supplies its own."""
    mrr = 1.0 / rank
    ndcg = 1.0 / torch.log2(rank + 1.0)
    zero = torch.zeros_like(ndcg)
    return {
        "mrr": mrr,
        "ndcg5": torch.where(rank <= 5, ndcg, zero),
        "ndcg10": torch.where(rank <= 10, ndcg, zero),
    }


def ranking_metrics_batch(scores: torch.Tensor, positive_index: int = 0) -> dict:
    """Per-impression AUC/MRR/NDCG@5/NDCG@10 of (B, C) scores whose column
    ``positive_index`` is the single positive. With rank r (1-based):
    AUC = (C - r) / (C - 1), MRR = 1 / r, NDCG@k = 1/log2(r+1) if r <= k.
    Ties count against the positive (a negative with an equal score
    outranks it), which gives a deterministic result."""
    c = scores.shape[1]
    pos = scores[:, positive_index : positive_index + 1]
    others = torch.cat([scores[:, :positive_index], scores[:, positive_index + 1 :]], dim=1)
    rank = 1.0 + (others >= pos).sum(dim=1).to(torch.float32)
    return {"auc": (c - rank) / (c - 1), **_metrics_from_rank(rank)}


def full_pool_metrics_batch(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    neg_mask: torch.Tensor,
) -> dict:
    """Per-impression AUC/MRR/NDCG over each impression's full negative pool.

    ``pos_scores`` (B,), ``neg_scores`` (B, P) over the padded pool,
    ``neg_mask`` (B, P) 1 for real negatives. With n_neg = the mask's sum,
    r = 1 + #{real negatives scoring >= the positive}, AUC = (n_neg - (r -
    1)) / n_neg; MRR and NDCG as :func:`ranking_metrics_batch`. Impressions
    with no real negative get AUC 0; the caller masks them out."""
    pos = pos_scores[:, None]
    mask = neg_mask.to(torch.float32)
    n_neg = mask.sum(dim=1)
    beaten_by = ((neg_scores >= pos).to(torch.float32) * mask).sum(dim=1)
    rank = 1.0 + beaten_by
    auc = torch.where(n_neg > 0, (n_neg - beaten_by) / n_neg.clamp(min=1.0),
                      torch.zeros_like(n_neg))
    return {"auc": auc, **_metrics_from_rank(rank)}


# --------------------------------------------------------------------------
# device-side quality stats: fixed-shape score histograms + reliability bins
# --------------------------------------------------------------------------

# every key quality_stats_batch returns
QUALITY_SUM_KEYS = (
    "q.pos_hist", "q.neg_hist",
    "q.pos_sum", "q.pos_sq", "q.pos_n",
    "q.neg_sum", "q.neg_sq", "q.neg_n",
    "q.cal_n", "q.cal_conf", "q.cal_label",
)


def _fixed_bin_counts(
    values: torch.Tensor, weights: torch.Tensor, lo: float, hi: float, bins: int
) -> torch.Tensor:
    """Weighted counts over ``bins`` equal-width buckets of [lo, hi).
    Values outside clamp to the edge bins (a histogram loses no mass to a
    range guess); non-finite values get weight 0. A one-hot product summed
    over rows: fixed shapes, no atomics."""
    width = (hi - lo) / bins
    idx = torch.floor((values - lo) / width).clamp(0, bins - 1)
    finite = torch.isfinite(values)
    # a NaN index has no bin: park it in bin 0 under a zero weight
    idx = torch.where(finite, idx, torch.zeros_like(idx)).to(torch.int64)
    w = torch.where(finite, weights, torch.zeros_like(weights)).to(torch.float32)
    onehot = F.one_hot(idx, bins).to(torch.float32)
    return (onehot * w.unsqueeze(-1)).reshape(-1, bins).sum(dim=0)


def quality_stats_batch(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    neg_mask: torch.Tensor,
    keep: torch.Tensor,
    score_bins: int,
    score_range: float,
    ece_bins: int,
) -> dict:
    """Score-distribution and calibration partial sums for one eval batch,
    every output of a fixed shape:

      * ``q.pos_hist`` / ``q.neg_hist``: (score_bins,) weighted counts of
        positive / real-negative scores over [-score_range, score_range]
        (the edge bins absorb outliers);
      * ``q.pos_sum`` / ``q.pos_sq`` / ``q.pos_n`` (and ``neg_``): moments;
      * ``q.cal_n`` / ``q.cal_conf`` / ``q.cal_label``: (ece_bins,)
        reliability-table sums over ``sigmoid(score)``, label 1 for
        positives and 0 for negatives.

    ``keep`` (B,) zeroes padded impressions, ``neg_mask`` (B, P) pool
    padding."""
    keep = keep.to(torch.float32)
    nw = neg_mask.to(torch.float32) * keep[:, None]
    pos, neg = pos_scores, neg_scores
    out = {
        "q.pos_hist": _fixed_bin_counts(pos, keep, -score_range, score_range, score_bins),
        "q.neg_hist": _fixed_bin_counts(neg, nw, -score_range, score_range, score_bins),
        "q.pos_sum": (pos * keep).sum(),
        "q.pos_sq": (pos * pos * keep).sum(),
        "q.pos_n": keep.sum(),
        "q.neg_sum": (neg * nw).sum(),
        "q.neg_sq": (neg * neg * nw).sum(),
        "q.neg_n": nw.sum(),
    }
    # bin b covers [b/B, (b+1)/B); probability 1.0 clamps into the last bin
    prob_pos = 1.0 / (1.0 + torch.exp(-pos))
    prob_neg = 1.0 / (1.0 + torch.exp(-neg))
    out["q.cal_n"] = (_fixed_bin_counts(prob_pos, keep, 0.0, 1.0, ece_bins)
                      + _fixed_bin_counts(prob_neg, nw, 0.0, 1.0, ece_bins))
    out["q.cal_conf"] = (_fixed_bin_counts(prob_pos, prob_pos * keep, 0.0, 1.0, ece_bins)
                         + _fixed_bin_counts(prob_neg, prob_neg * nw, 0.0, 1.0, ece_bins))
    # positives contribute label 1 each, negatives 0
    out["q.cal_label"] = _fixed_bin_counts(prob_pos, keep, 0.0, 1.0, ece_bins)
    return out
