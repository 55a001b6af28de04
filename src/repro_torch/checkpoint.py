"""Dependency-free checkpoints, counterpart of ``src/repro/checkpoint.py``
and in its format: ``arrays.npz`` holds the leaves as ``leaf_<i>`` in the
reference's flatten order (dict keys sorted, lists and tuples in order,
None an empty node), bf16 written as f32 (numpy has no bf16), and
``meta.json`` the structure, the leaf count and the step. Each package
restores the other's checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, it) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    return next(it)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(tree)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        structure = _unflatten(tree, iter(["*"] * len(leaves)))
        json.dump({"treedef": repr(structure), "num_leaves": len(leaves),
                   "step": step}, f)


def restore(path: str, like: Any) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors giving
    each leaf's dtype and device); returns (tree, step)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like_leaves = _flatten(like)
    if meta["num_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, the "
                         f"structure to restore into {len(like_leaves)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [torch.from_numpy(data[f"leaf_{i}"]).to(
                      dtype=x.dtype, device=x.device)
                  for i, x in enumerate(like_leaves)]
    return _unflatten(like, iter(leaves)), meta["step"]
