"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are flattened in **sorted key order**, as ``jax.tree_util`` orders
a dict, so leaf lists and checkpoint leaf names line up with the
reference's.  Only dicts are containers here; anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_names(tree, prefix: str = "") -> list[str]:
    """``"a/b/c"`` path of every leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in tree_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in sorted order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}   # consumes in order
            return {k: built[k] for k in t}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
