"""Flattening of nested parameter trees in ``jax.tree_util``'s leaf order.

The codecs, the host reductions and the coordinator's wire address a
parameter by its index in the flattened contribution tree: top-k breaks
ties by the lowest flat index, the sketches key their hashes on the leaf's
index. So the port flattens its trees (nested dicts, tuples and lists of
arrays, in the Flax layout of ``params.to_flax``) in the order JAX does:
dict keys sorted, sequences in order, depth first. A ``None`` is an empty
node, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable

# treedef nodes: ("leaf",), ("none",), ("dict", keys, children),
# ("tuple" | "list", children)
TreeDef = tuple


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """``(leaves, treedef)``: the leaves depth first, dict keys sorted."""
    leaves: list = []

    def walk(node: Any) -> TreeDef:
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (tuple, list)):
            return ("tuple" if isinstance(node, tuple) else "list", [walk(c) for c in node])
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: TreeDef, leaves: list) -> Any:
    """The inverse of :func:`tree_flatten`; raises when the leaf count
    differs from the structure's."""
    it = iter(leaves)

    def build(d: TreeDef) -> Any:
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return tuple(children) if kind == "tuple" else children

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


_END = object()


def num_leaves(treedef: TreeDef) -> int:
    kind = treedef[0]
    if kind == "leaf":
        return 1
    if kind == "none":
        return 0
    return sum(num_leaves(c) for c in treedef[-1])


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(x, *xs) for x, *xs in zip(leaves, *others)])


def tree_paths(tree: Any) -> list[tuple]:
    """Each leaf's key path (dict keys, sequence indices), in leaf order."""
    paths: list[tuple] = []

    def walk(node: Any, path: tuple) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, c in enumerate(node):
                walk(c, path + (i,))
        else:
            paths.append(path)

    walk(tree, ())
    return paths
