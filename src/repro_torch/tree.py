"""Parameter trees: nested dicts and lists with tensors (or any other
object) at the leaves — the tree the JAX package's params use, minus
JAX's pytree registry."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which share its structure; dicts and lists are the only containers."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """The leaves in ``tree_map``'s order."""
    out: list[Any] = []
    tree_map(out.append, tree)
    return out
