"""Sharding rules, counterpart of ``src/repro/launch/sharding.py``:
parameter path -> partition spec, activation hints, batch and cache
specs, and the server accumulator's placement.

Every rule is a pure function of (path, shape, mesh extents) and gives
the reference's ``PartitionSpec`` entries as a tuple: one entry per
tensor dim, each an axis name, a tuple of axis names, or None. ``ext``
is ``{axis name: extent}`` (``mesh.extents(device_mesh)``). An axis is
used only where the dim divides by its extent; a tuple request falls
back to its first member that divides.

Layout:
  * batch over ("pod", "data");
  * attention heads, ffn hidden and vocab over "model";
  * the other weight dim (FSDP-style) over ("pod", "data");
  * MoE experts over "model" where they divide (expert parallel), else
    the expert ffn dim (tensor parallel inside each expert).

``placements`` turns a spec into DTensor placements on a
``DeviceMesh``. The port runs on one card, where every placement is
replication; laying tensors out across several cards is ROADMAP item
10b.
"""

from __future__ import annotations

from typing import Any, Optional

from ..tree import tree_leaves

Spec = tuple


def _batch_axes(ext: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in ext)


def _ax(ext: dict, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _ax(ext, n)
        return out
    return int(ext.get(name, 1))


def _fits(dim: int, ext: dict, name) -> bool:
    return dim % _ax(ext, name) == 0


def _spec(ext: dict, shape, wants) -> Spec:
    """wants: per dim an axis name, a tuple of them, or None; a request
    that does not divide its dim is dropped (a tuple's first dividing
    member is kept). A tuple of one name is that name and an empty one
    None, as ``PartitionSpec`` normalizes them."""
    out = []
    for dim, w in zip(shape, wants):
        if w is None:
            out.append(None)
        elif _fits(dim, ext, w):
            out.append(w)
        elif isinstance(w, tuple):
            out.append(next((sub for sub in w if _fits(dim, ext, sub)), None))
        else:
            out.append(None)
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in out)


# -- parameters -------------------------------------------------------------


def param_spec(path: str, shape, ext: dict) -> Spec:
    """``path`` is the '/'-joined key path ("params/layers/0/mixer/wq");
    a stacked layer axis (under "layers" or "enc_layers") is dim 0."""
    ba = _batch_axes(ext)
    name = path.split("/")[-1]
    stacked = "layers" in path or "enc_layers" in path
    body = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()

    def done(wants):
        return _spec(ext, shape, lead + tuple(wants))

    if name in ("embed", "lm_head"):
        return _spec(ext, shape, ("model", ba))
    if len(body) <= 1:
        if name in ("bq", "bk", "bv") and len(body) == 1:
            return done(["model"])
        return done([None] * len(body))
    if len(body) == 3 and name in ("wi", "wg", "wo"):
        if _fits(body[0], ext, "model"):
            return done(["model", ba, None])
        if name == "wo":
            return done([None, "model", ba])
        return done([None, ba, "model"])
    if name == "router":
        return done([None, None])
    if len(body) == 2:
        if name in ("wdq", "wdkv", "wkrope"):
            return done([ba, None])
        if name == "wuq":
            return done([None, "model"])
        if name in ("wo", "wout", "wuk", "wuv"):
            return done(["model", ba])
        return done([ba, "model"])
    return done([None] * len(body))


def _walk(tree, prefix: str, leaf):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{prefix}/{k}", leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, f"{prefix}/{i}", leaf) for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return leaf(prefix, tree)


def tree_param_specs(params: Any, ext: dict):
    """The params tree (tensors, meta tensors or anything with
    ``.shape``) -> the same tree of specs."""
    return _walk(params, "params",
                 lambda path, p: param_spec(path, tuple(p.shape), ext))


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


def opt_state_shardings(state: Any, params: Any, ext: dict):
    """Specs for an optimizer state (a NamedTuple of trees): a field
    that mirrors the params tree, leaf shapes included (Adam's moments,
    fednl's H and momentum), takes the params' own specs; every other
    field (step counters, the per-tensor ridge, an unset slot) is
    replicated, ``()`` per leaf."""
    pspecs = tree_param_specs(params, ext)
    pdef = _structure(params)
    pshapes = [tuple(p.shape) for p in tree_leaves(params)]

    def field(sub):
        if sub is None:
            return None
        mirrors = (_structure(sub) == pdef and
                   [tuple(getattr(x, "shape", ())) for x in tree_leaves(sub)]
                   == pshapes)
        if mirrors:
            return pspecs
        return _walk(sub, "", lambda path, x: ())

    if hasattr(state, "_fields"):
        return type(state)(*[field(f) for f in state])
    return field(state)


# -- activations --------------------------------------------------------------


def make_activation_sharder(ext: dict):
    """``spec(shape, kind)``: an activation's spec by kind ("btd",
    "btf", "bthd", "logits", "ecf", "moe_route", "carry"); None for a
    kind with no rule (the reference leaves such a tensor as it is)."""
    ba = _batch_axes(ext)

    def spec(shape, kind: str) -> Optional[Spec]:
        ndim = len(shape)
        if kind == "btd":
            wants = (ba,) + (None,) * (ndim - 1)
        elif kind in ("btf", "logits"):
            wants = (ba,) + (None,) * (ndim - 2) + ("model",)
        elif kind == "bthd":
            wants = (ba, None, "model", None)
        elif kind == "ecf":
            if _fits(shape[1], ext, "model"):
                wants = (ba, "model") + (None,) * (ndim - 2)
            else:
                wants = (ba,) + (None,) * (ndim - 2) + ("model",)
        elif kind == "moe_route":
            wants = (ba,) + (None,) * (ndim - 1)
        elif kind == "carry":
            wants = (ba, "model", None)
        else:
            return None
        return _spec(ext, shape, wants)

    return spec


# -- the server accumulator -----------------------------------------------------


def accumulator_spec(ext: dict, shape, axis: str = "data") -> Spec:
    """The dense (d0, d1) server accumulator: rows over ``axis``, the
    layout ``sharded_scatter_accumulate`` gives each rank; replicated
    where d0 does not divide the axis (the sharded sum then refuses)."""
    return _spec(ext, shape, (axis, None))


# -- batches and caches ------------------------------------------------------------


def batch_specs(batch: Any, ext: dict):
    ba = _batch_axes(ext)
    return _walk(batch, "", lambda path, x: _spec(
        ext, tuple(x.shape), (ba,) + (None,) * (len(x.shape) - 1)))


def cache_specs(cache: Any, ext: dict):
    """KV caches: batch over ("pod", "data"); the kv-head dim over
    "model" where it divides, else the sequence dim, else replicated.
    Recurrent states: the feature dim over "model"."""
    ba = _batch_axes(ext)

    def leaf(path, x):
        shape = tuple(x.shape)
        name = path.split("/")[-1]
        if name in ("k", "v"):                 # (seg, B, S, KV, hd)
            wants = (None, ba, None, "model", None)
            if (not _fits(shape[3], ext, "model")
                    and _fits(shape[2], ext, "model")):
                wants = (None, ba, "model", None, None)
            return _spec(ext, shape, wants)
        if name in ("ckv", "krope"):           # (seg, B, S, r)
            return _spec(ext, shape, (None, ba, "model" if _fits(
                shape[2], ext, "model") else None, None))
        if name == "conv":                     # (seg, B, k, Di)
            return _spec(ext, shape, (None, ba, None, "model"))
        if name == "ssm":                      # (seg, B, Di, S)
            return _spec(ext, shape, (None, ba, "model", None))
        if name == "c" and len(shape) == 5:    # mlstm (seg, B, H, hd, hd)
            return _spec(ext, shape, (None, ba, "model", None, None))
        if name in ("c", "n", "m", "h"):
            return _spec(ext, shape, (None, ba) + (None,) * (len(shape) - 2))
        if name == "enc":                      # (B, S_enc, d)
            return _spec(ext, shape, (ba, None, None))
        return _spec(ext, shape, (None,) * len(shape))

    return _walk(cache, "cache", leaf)


# -- DTensor placements ----------------------------------------------------------


def placements(mesh, spec: Spec) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``:
    ``Shard(dim)`` on each mesh axis that a tensor dim names, else
    ``Replicate()``. An axis of extent 1 is replication."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            i = names.index(axis)
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return out
