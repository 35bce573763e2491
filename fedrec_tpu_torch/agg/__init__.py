"""Aggregation topologies (``agg.*``): the hierarchical tiered reduce. The
async buffered commit (``agg/buffer.py``, ``commit.py``, ``server.py``,
``worker.py`` of the JAX package) is ROADMAP.md's Queue A item 9."""

from fedrec_tpu_torch.agg.hierarchy import build_tree, tree_critical_path_ms, tree_reduce_np

__all__ = ["build_tree", "tree_critical_path_ms", "tree_reduce_np"]
