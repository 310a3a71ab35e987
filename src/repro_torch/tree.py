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
    return leaves, _walk(tree, leaves)


def _walk(t, leaves: list):
    # module-level, not a closure: a nested function that calls itself
    # sits in a reference cycle with the list it fills, which kept every
    # leaf (a whole training state) alive until the garbage collector ran
    if isinstance(t, dict):
        return {k: _walk(t[k], leaves) for k in sorted(t)}
    leaves.append(t)
    return None


def unflatten(treedef: Any, leaves: list) -> Tree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def leaves(tree: Tree) -> list:
    return flatten(tree)[0]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """Apply `fn` leafwise over one or more trees of equal structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
