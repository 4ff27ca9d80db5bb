"""Minimal pytree helpers for machine state and ``LaneState`` fields.

A tree is a tensor, a tuple/list/NamedTuple of trees, or a dict of
trees.  Leaves come out in ``jax.tree.flatten`` order (sequence order;
dict keys sorted), which is the order the ``<field>:<leaf>`` checkpoint
keys use, so archives of either engine line up leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (an iterable)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and trees of the same
    structure."""
    cols = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return tree_unflatten(tree, (fn(*c) for c in cols))
