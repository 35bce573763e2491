"""Aggregation topologies (``agg.mode``): the hierarchical tiered reduce
(``agg.hierarchy``) and the buffered quorum commit of ``agg.mode="async"``
(``agg.buffer``, ``agg.commit``), which the ``Trainer`` runs in process and
the async deployment runs over the wire: the commit authority
(``agg.server``, ``python -m fedrec_tpu_torch.agg.server``) and its workers
(``agg.worker.run_async_worker``, the run CLI's ``--agg-server``).

The wire's names load on first use, so that running ``agg.server`` as a
module does not import it twice."""

import importlib

from fedrec_tpu_torch.agg.buffer import AGG_BUFFER_SIDECAR, AggBuffer, BufferEntry
from fedrec_tpu_torch.agg.commit import (
    CommitPolicy,
    CommitStats,
    encode_contribution,
    fold_commit,
    staleness_weight,
)
from fedrec_tpu_torch.agg.hierarchy import build_tree, tree_critical_path_ms, tree_reduce_np

_LAZY = {
    "AGG_GLOBAL_SIDECAR": "server",
    "AggServer": "server",
    "decode_leaves": "server",
    "decode_payloads": "server",
    "encode_leaves": "server",
    "encode_payloads": "server",
    "run_async_worker": "worker",
}

__all__ = sorted(["AGG_BUFFER_SIDECAR", "AggBuffer", "BufferEntry", "CommitPolicy",
                  "CommitStats", "build_tree", "encode_contribution", "fold_commit",
                  "staleness_weight", "tree_critical_path_ms", "tree_reduce_np", *_LAZY])


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
