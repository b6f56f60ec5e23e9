"""Nested containers of tensors ("trees") in JAX's flatten order.

The port keeps params and optimizer state as plain dicts, as the JAX
package does, and two of its modules need JAX's leaf order: the global
gradient norm sums leaves in it, and checkpoints store leaves in it, so
that either framework reads the other's files.  The order: a dict's
values by sorted key, a list's or tuple's in order, ``None`` holds no
leaf, anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "tree_map", "unflatten", "describe"]


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    if tree is None:
        return []
    return [tree]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}  # keep the caller's key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        if node is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    cols = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def describe(tree) -> str:
    """The structure, with ``*`` for each leaf (a checkpoint manifest's
    ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "(" + ", ".join(describe(sub) for sub in tree) + ")"
    return "None" if tree is None else "*"
