"""Nested-dict parameter trees: leaves in the reference's order.

The JAX package keeps parameters, gradients and optimizer moments as
nested dicts and walks them with ``jax.tree_util``, which visits dict keys
in SORTED order.  That order decides the gradient buckets
(``train/occl_sync.py`` bucketizes the leaves in reverse), so the port
flattens its trees the same way: :func:`tree_leaves` and
:func:`tree_unflatten` over dicts (sorted keys), lists and tuples.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf-wise over trees of one structure."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
