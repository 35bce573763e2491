"""Ranking metrics for the port (``eval/metrics.py``)."""

from fedrec_tpu_torch.eval.metrics import (
    QUALITY_SUM_KEYS,
    auc_score,
    compute_amn,
    dcg_score,
    evaluation_split,
    full_pool_metrics_batch,
    mrr_score,
    ndcg_score,
    quality_stats_batch,
    ranking_metrics_batch,
    safe_auc_score,
)

__all__ = [
    "QUALITY_SUM_KEYS",
    "auc_score",
    "compute_amn",
    "dcg_score",
    "evaluation_split",
    "full_pool_metrics_batch",
    "mrr_score",
    "ndcg_score",
    "quality_stats_batch",
    "ranking_metrics_batch",
    "safe_auc_score",
]
