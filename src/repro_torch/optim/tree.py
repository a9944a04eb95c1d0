"""Nested dicts of tensors as trees: the port's stand-in for ``jax.tree``.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
gives a dict, so sums over leaves add in the JAX package's order.
``None`` is an empty tree.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def leaves(tree: Tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def unflatten_like(tree: Tree, flat: List[Any]) -> Tree:
    """The leaves ``flat`` (in :func:`leaves` order) in ``tree``'s shape."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}   # consume in order
            return {k: built[k] for k in t}
        return next(it)
    return build(tree)
