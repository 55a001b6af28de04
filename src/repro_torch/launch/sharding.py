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
``DeviceMesh``, and ``shard_tree`` lays a tree out by them (the
reference's ``jax.device_put(tree, shardings)``). A step on a
``("data", "model")`` mesh whose model axis is one rank
(``launch.steps.make_train_step`` with ``mesh``) works on each rank's
shards: ``DataAxis`` and ``LeafLayout`` are the collectives it makes
for a leaf, ``LocalShard`` the form in which the model receives a split
weight, and the installed hooks (``make_layer_param_constrainer``,
``make_activation_constraint``) gather each split weight whole a layer
at a time inside the model's loop.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map

# the flat collectives, by their names since torch 2.13 where there
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)

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


# -- laying a tree out over the ranks ---------------------------------------------


def _over(fn, tree, *rest):
    """``tree_map`` that also walks the fields of an optimizer state (a
    NamedTuple)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[_over(fn, *xs) for xs in zip(tree, *rest)])
    return tree_map(fn, tree, *rest)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_tree(tree, mesh, specs):
    """``tree``'s tensors as DTensors on ``mesh`` with the placements of
    ``specs`` (``tree_param_specs``, or ``opt_state_shardings`` for an
    optimizer state): every rank holds the same tree (drawn from one
    seed) and keeps its own slice of each tensor, so no data moves.
    Other leaves (a step count, an unset slot) stay as they are."""
    from torch.distributed.tensor import distribute_tensor

    def leaf(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x, mesh, placements(mesh, spec),
                                 src_data_rank=None)

    return _over(leaf, tree, specs)


def local_tree(tree):
    """Each DTensor leaf's local tensor, this rank's shard (views, no
    copy); other leaves as they are."""
    return _over(lambda x: x.to_local() if _is_dtensor(x) else x, tree)


def like_tree(new, like):
    """``new``'s local tensors as DTensors laid out as the leaves of
    ``like`` are; a leaf of ``like`` that is no DTensor keeps ``new``'s."""
    from torch.distributed.tensor import DTensor

    def leaf(n, old):
        if not _is_dtensor(old):
            return n
        return DTensor.from_local(n, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())

    return _over(leaf, new, like)


def whole_tree(tree):
    """Each DTensor leaf gathered whole on every rank (a collective: every
    rank calls it)."""
    return _over(lambda x: x.full_tensor() if _is_dtensor(x) else x, tree)


class DataAxis:
    """The "data" axis of a mesh whose other axes are one rank each: its
    process group, extent and this rank's place on it. A mesh that
    splits tensors over another axis (tensor parallelism over "model")
    is not laid out by the port and is refused."""

    def __init__(self, mesh):
        names = mesh.mesh_dim_names
        wide = [n for n, e in zip(names, mesh.shape) if e > 1 and n != "data"]
        if wide:
            raise NotImplementedError(
                f"the mesh splits over {wide}: only the data axis may hold "
                f"more than one rank (a weight split over 'model' is not "
                f"laid out)")
        self.mesh = mesh
        self.group = mesh.get_group("data")
        self.world = int(mesh.size(names.index("data")))
        self.rank = int(mesh.get_local_rank("data"))

    def layout(self, x) -> "LeafLayout":
        """A leaf's ``LeafLayout``: a DTensor's by its placement on this
        axis; any other tensor is held whole by every rank."""
        if not _is_dtensor(x):
            return LeafLayout(None, self)
        from torch.distributed.tensor import Shard

        p = x.placements[self.mesh.mesh_dim_names.index("data")]
        return LeafLayout(p.dim if isinstance(p, Shard) else None, self)

    def gather(self, *parts: torch.Tensor) -> tuple:
        """Each rank's tensors stacked on their leading axis in rank order
        (all-gather)."""
        if self.world == 1:
            return parts
        out = []
        for x in parts:
            x = x.contiguous()
            buf = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
            _all_gather(buf, x, group=self.group)
            out.append(buf)
        return tuple(out)

    def sum(self, tensors: list, pick: list) -> list:
        """``tensors`` with those where ``pick`` is true summed over the
        ranks, in f32, in one all-reduce of them flattened; each cast
        back to its own dtype."""
        chosen = [t for t, p in zip(tensors, pick) if p]
        if not chosen or self.world == 1:
            return list(tensors)
        flat = torch.cat([t.to(torch.float32).reshape(-1) for t in chosen])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for t, p in zip(tensors, pick):
            if p:
                out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
                at += t.numel()
            else:
                out.append(t)
        return out


class LeafLayout:
    """How one leaf lies on ``axis``: ``dim`` is the tensor dim split
    evenly over its ranks, None when each rank holds the leaf whole. The
    collectives a step makes for it."""

    def __init__(self, dim: Optional[int], axis: DataAxis):
        self.dim, self.axis = dim, axis

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard (all-gather); the
        shard itself when the leaf is not split."""
        if self.dim is None:
            return local
        out, = self.axis.gather(local.movedim(self.dim, 0))
        return out.movedim(0, self.dim).contiguous()

    def part(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor (a view)."""
        if self.dim is None:
            return whole
        size = whole.shape[self.dim] // self.axis.world
        return whole.narrow(self.dim, self.axis.rank * size, size)

    def sum_part(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the sum over the ranks of a whole tensor
        each rank has its own of (reduce-scatter, in f32)."""
        x = whole.movedim(self.dim, 0).to(torch.float32).contiguous()
        out = x.new_empty((x.shape[0] // self.axis.world,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x, group=self.axis.group)
        return out.movedim(0, self.dim).to(whole.dtype).contiguous()


class _Gathered(torch.autograd.Function):
    """A shard gathered whole for the forward; the backward gives this
    rank's shard of the sum over the ranks of the whole gradient."""

    @staticmethod
    def forward(ctx, local, lay):
        ctx.lay = lay
        return lay.whole(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.lay.sum_part(grad), None


class LocalShard:
    """A rank's shard of a split weight as the model receives it on a
    mesh: indexing takes one layer of a stacked leaf (the layer axis is
    never split), and the installed ``shard_layer_params`` gathers it."""

    __slots__ = ("local", "dim")

    def __init__(self, local: torch.Tensor, dim: int):
        self.local, self.dim = local, dim

    def __getitem__(self, i):
        if self.dim == 0:
            raise IndexError("a split weight's split dim cannot be indexed")
        return LocalShard(self.local[i], self.dim - 1)

    @property
    def requires_grad(self) -> bool:
        return self.local.requires_grad


def make_layer_param_constrainer(mesh):
    """The installed ``shard_layer_params`` on ``mesh``, called on each
    layer's slice inside the model's loop and on the weights outside the
    stacks: every ``LocalShard`` gathered whole on each rank, its
    gradient summed over the ranks onto each rank's shard; other leaves
    (held whole) as they are. Under remat the gather is recomputed in the
    backward, so the peak holds one layer's gathered weights, not the
    stack's (the reason the reference pins the slice inside the scan)."""
    axis = DataAxis(mesh)

    def constrain(tree):
        return tree_map(
            lambda x: (_Gathered.apply(x.local, LeafLayout(x.dim, axis))
                       if isinstance(x, LocalShard) else x), tree)

    return constrain


def make_activation_constraint(mesh):
    """The installed ``shard_act`` on ``mesh``: ``(x, kind) -> x``. Every
    rule of ``make_activation_sharder`` asks the batch over ("pod",
    "data") on dim 0, which is what a rank's own rows are, and "model"
    elsewhere, which is one rank (``DataAxis`` refuses a wider one)."""
    DataAxis(mesh)

    def constrain(x, kind: str):
        return x

    return constrain
