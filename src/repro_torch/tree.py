"""Nested-dict parameter trees: leaves in the reference's order.

The JAX package keeps parameters, gradients and optimizer moments as
nested dicts and walks them with ``jax.tree_util``, which visits dict keys
in SORTED order.  That order decides the gradient buckets
(``train/occl_sync.py`` bucketizes the leaves in reverse), so the port
flattens its trees the same way: :func:`tree_leaves` and
:func:`tree_unflatten` over dicts (sorted keys), NamedTuples, lists and
tuples.  :func:`tree_leaves_with_path` names each leaf as the reference's
checkpoints do (``checkpoint/ckpt.py``): a NamedTuple field prints as
``.name`` (``jax.tree_util.GetAttrKey``), a dict key as itself, a list or
tuple index as its number, joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """``(key, leaf)`` pairs in leaf order, keyed as the reference's
    ``checkpoint.ckpt._flatten`` keys them (e.g. ``.params/layers/attn/wk``
    in a ``TrainState``)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in tree_leaves_with_path(v, f"{prefix}/{k}" if prefix
                                            else k)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
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
