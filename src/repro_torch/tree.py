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


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves``'s order)
    in place of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# a second route to a function (ranks that split its sums, say) may move
# its outputs by this many times the function's own spread under
# ``nudged`` weights where its conditioning, not the route, sets how far
# a rounding carries (xLSTM's mLSTM normalizer)
SPREAD_FACTOR = 4


def nudged(tree, generator):
    """Every floating leaf of ``tree`` times 1 + u z, z ~ N(0, 1) drawn
    from ``generator`` (on the leaves' device), u the leaf type's unit
    roundoff (2^-24 in f32, 2^-8 in bf16): a change of one rounding's
    size. How far a function's outputs move under it is the function's
    own spread under rounding."""
    import torch

    def one(x):
        if not torch.is_floating_point(x):
            return x
        z = torch.randn(x.shape, generator=generator, device=x.device)
        return (x.float() * (1 + torch.finfo(x.dtype).eps / 2 * z)
                ).to(x.dtype)

    return tree_map(one, tree)
