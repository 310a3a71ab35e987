"""Nested-dict trees: the port's stand-in for `jax.tree` on parameter trees.

Leaves are taken in the order `jax.tree.flatten` takes them for nested
dicts — keys sorted at every level — so a flat buffer built from the same
tree lays its leaves at the same offsets in both packages
(`core/flat.py`).
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def flatten(tree: Tree) -> tuple[list, Any]:
    """-> (leaves in sorted-key order, treedef).  The treedef is the tree
    with every leaf replaced by None; equal treedefs mean equal structure."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        leaves.append(t)
        return None

    return leaves, walk(tree)


def unflatten(treedef: Any, leaves: list) -> Tree:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree: Tree) -> list:
    return flatten(tree)[0]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """Apply `fn` leafwise over one or more trees of equal structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
