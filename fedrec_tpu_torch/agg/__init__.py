"""Aggregation topologies (``agg.mode``): the hierarchical tiered reduce
(``agg.hierarchy``) and the buffered quorum commit of ``agg.mode="async"``
(``agg.buffer``, ``agg.commit``), which the ``Trainer`` runs in process.
The async deployment over the wire (the JAX package's ``agg/server.py`` and
``worker.py``) is ROADMAP.md's Queue A item 9."""

from fedrec_tpu_torch.agg.buffer import AGG_BUFFER_SIDECAR, AggBuffer, BufferEntry
from fedrec_tpu_torch.agg.commit import (
    CommitPolicy,
    CommitStats,
    encode_contribution,
    fold_commit,
    staleness_weight,
)
from fedrec_tpu_torch.agg.hierarchy import build_tree, tree_critical_path_ms, tree_reduce_np

__all__ = ["AGG_BUFFER_SIDECAR", "AggBuffer", "BufferEntry", "CommitPolicy", "CommitStats",
           "build_tree", "encode_contribution", "fold_commit", "staleness_weight",
           "tree_critical_path_ms", "tree_reduce_np"]
