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
``DeviceMesh``; ``local_keep`` narrows each leaf a model draws to this
rank's shard and ``from_local_tree`` makes the shards DTensors (the
reference's ``jax.device_put(tree, shardings)``, without the whole tree
on any rank). A step on a ``("data", "model")`` mesh
(``launch.steps.make_train_step`` with ``mesh``) works on each rank's
shards: ``DataAxis`` (with ``model``, a ``ModelAxis``) and
``LeafLayout`` are the collectives it makes for a leaf, ``LocalShard``
the form in which the model receives a "data"-split weight, and the
installed hooks (``make_layer_param_constrainer``,
``make_activation_constraint``, ``make_model_axis``) gather each such
weight a layer at a time inside the model's loop while the layers
compute tensor-parallel on their "model" shards.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..models.transformer import layer_kinds
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


def _sum_type(dtype: torch.dtype) -> torch.dtype:
    """The type a sum over the ranks runs in: f32, or f64 for f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class _Axis:
    """One axis of a mesh: its process group, extent and this rank's place
    on it, and the collectives over it. Sums run in f32 (f64 stays f64,
    ``_sum_type``) on the calling stream. A mesh without the axis gives
    an axis of one rank. The three primitives are the only calls that
    cross ranks (``chip_smoke.py`` plays the ranks of one card in turn
    through a subclass that replaces them, and in its phase 16g runs
    them through the host for rank processes on one card)."""

    def __init__(self, mesh, name: str):
        names = mesh.mesh_dim_names if mesh is not None else ()
        self.name = name
        if name in names:
            self.world = int(mesh.size(names.index(name)))
            self.rank = int(mesh.get_local_rank(name))
            self.group = mesh.get_group(name)
        else:
            self.world, self.rank, self.group = 1, 0, None

    # -- the primitives ----------------------------------------------------

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Each rank's contiguous ``x`` concatenated on dim 0 in rank
        order."""
        buf = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(buf, x, group=self.group)
        return buf

    def _all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks in place ("sum" or "max")."""
        dist.all_reduce(x, op=(dist.ReduceOp.SUM if op == "sum"
                               else dist.ReduceOp.MAX), group=self.group)
        return x

    def _reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of dim 0 of the sum over the ranks of ``x``."""
        out = x.new_empty((x.shape[0] // self.world,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x, group=self.group)
        return out

    # -- built on them -------------------------------------------------------

    def gather(self, *parts: torch.Tensor) -> tuple:
        """Each rank's tensors stacked on their leading axis in rank order
        (all-gather)."""
        if self.world == 1:
            return parts
        return tuple(self._all_gather(x.contiguous()) for x in parts)

    def sum(self, tensors: list, pick: list) -> list:
        """``tensors`` with those where ``pick`` is true summed over the
        ranks, in f32, in one all-reduce of them flattened; each cast
        back to its own dtype."""
        chosen = [t for t, p in zip(tensors, pick) if p]
        if not chosen or self.world == 1:
            return list(tensors)
        flat = torch.cat([t.to(_sum_type(t.dtype)).reshape(-1)
                          for t in chosen])
        self._all_reduce(flat)
        out, at = [], 0
        for t, p in zip(tensors, pick):
            if p:
                out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
                at += t.numel()
            else:
                out.append(t)
        return out

    def whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's shard split on ``dim``."""
        if self.world == 1:
            return x
        buf = self._all_gather(x.movedim(dim, 0).contiguous())
        return buf.movedim(0, dim).contiguous()

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard on ``dim`` of a whole tensor (a view)."""
        size = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * size, size)

    def sum_part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard on ``dim`` of the sum over the ranks of a
        whole tensor each rank has its own of (reduce-scatter, in f32)."""
        y = x.movedim(dim, 0).to(_sum_type(x.dtype)).contiguous()
        return self._reduce_scatter(y).movedim(0, dim).to(x.dtype).contiguous()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new contiguous tensor: ``x`` reduced over the ranks in f32
        (the max in ``x``'s own type), cast back to its type. ``x`` may
        have any strides (a gradient in a double backward can be a
        transposed view; NCCL takes contiguous tensors only)."""
        if self.world == 1:
            return x
        if op == "max":
            return self._all_reduce(
                x.clone(memory_format=torch.contiguous_format), "max")
        return self._all_reduce(x.to(
            _sum_type(x.dtype), memory_format=torch.contiguous_format,
            copy=True)).to(x.dtype)


class ModelAxis(_Axis):
    """The mesh's "model" axis and the tensor-parallel operators of a
    model laid out over it (Megatron's pairs, as autograd functions):

    * ``copy_in`` at a column-parallel input: identity forward, the
      gradient summed over the ranks backward;
    * ``reduce_out`` at a row-parallel output: the partial products summed
      over the ranks forward, identity backward;
    * ``gather_weight``: a weight's shards gathered whole forward, this
      rank's shard of the summed gradient backward (a layer that needs the
      whole of a split weight: the reference's reshard where a head count
      does not divide);
    * ``weight_whole``: a weight whole on a dim whether the rules split
      it (``gather_weight``) or not (``copy_in``), for a layer whose ranks
      each use a part of it (MLA's ``wuq``/``wuk``/``wuv``, a Mamba
      mixer's per-channel weights);
    * ``split_on`` / ``gather_on``: keep this rank's block of a dim
      forward and all-gather the gradient backward; all-gather the dim
      forward and keep the rank's block of the gradient backward.
      ``split_seq`` / ``gather_seq`` are the pair on dim 1 (T), the
      ``carry`` hint's sequence parallelism. The gradient that reaches a
      gathered carry is whole on every rank (the residual stream's is,
      by the pairs above), so its rows need no sum. The MoE's combine
      weights take ``split_on`` their expert dim under expert
      parallelism: each rank weighs its own experts' outputs, and the
      backward gathers the other ranks' columns, so the router's
      gradient is whole on every rank.

    Each operator is linear, so the backward of its backward is its
    forward: each backward is the ``apply`` of its dual (``copy_in`` <->
    ``reduce_out``, ``gather_weight`` <-> ``_SumPart``, the
    reduce-scatter, ``split_on`` <-> ``gather_on``), which autograd
    differentiates again under ``create_graph``. So a double backward
    (Hutchinson's Hz, ``launch.steps.grad_and_hvp``) runs through the
    same collectives, transposed.
    """

    def __init__(self, mesh=None):
        super().__init__(mesh, "model")

    def copy_in(self, x):
        return _CopyIn.apply(x, self)

    def reduce_out(self, x):
        return _ReduceOut.apply(x, self)

    def gather_weight(self, x, dim: int):
        return _GatherWeight.apply(x, self, dim)

    def split_on(self, x, dim: int):
        return _SplitOn.apply(x, self, dim)

    def gather_on(self, x, dim: int):
        return _GatherOn.apply(x, self, dim)

    def weight_whole(self, w, dim: int, width: int):
        """A weight whole on ``dim`` (``width`` wide) for a layer of which
        each rank uses its own part: ``gather_weight`` where the rules
        split it over "model", ``copy_in`` where they hold it whole, so
        its gradient sums every rank's part either way."""
        if w.shape[dim] == width:
            return self.copy_in(w)
        return self.gather_weight(w, dim)

    def split_seq(self, x):
        return self.split_on(x, 1)

    def gather_seq(self, x):
        return self.gather_on(x, 1)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceOut.apply(grad, ctx.axis), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return _CopyIn.apply(grad, ctx.axis), None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.whole(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _SumPart.apply(grad, ctx.axis, ctx.dim), None, None


class _SumPart(torch.autograd.Function):
    """This rank's shard on ``dim`` of the sum over the ranks (reduce-
    scatter, ``ModelAxis.sum_part``): ``_GatherWeight``'s backward, whose
    own backward gathers the shards whole again."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.sum_part(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _GatherWeight.apply(grad, ctx.axis, ctx.dim), None, None


class _SplitOn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.part(x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherOn.apply(grad, ctx.axis, ctx.dim), None, None


class _GatherOn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.whole(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _SplitOn.apply(grad, ctx.axis, ctx.dim), None, None


class DataAxis(_Axis):
    """The mesh's "data" axis as a step sees it (a FedNL silo per index,
    the batch's rows split over it, FSDP's second weight split), with the
    "model" axis beside it as ``model`` (a ``ModelAxis``, one rank when
    the mesh has no wider one). Any other axis wider than one rank (a
    "pod" axis) is not laid out and is refused. ``mesh`` None is a data
    axis of one rank; ``model`` replaces the mesh's model axis (the
    ranks that ``chip_smoke.py`` plays on one card)."""

    def __init__(self, mesh, model: Optional[ModelAxis] = None):
        if mesh is not None:
            wide = [n for n, e in zip(mesh.mesh_dim_names, mesh.shape)
                    if e > 1 and n not in ("data", "model")]
            if wide:
                raise NotImplementedError(
                    f"the mesh splits over {wide}: only the 'data' and "
                    f"'model' axes are laid out")
        super().__init__(mesh, "data")
        self.mesh = mesh
        self.model = ModelAxis(mesh) if model is None else model

    def layout(self, x) -> "LeafLayout":
        """A leaf's ``LeafLayout``: a DTensor's by its placements on the
        two axes; any other tensor is held whole by every rank."""
        if not _is_dtensor(x):
            return LeafLayout(None, self)
        from torch.distributed.tensor import Shard

        names = self.mesh.mesh_dim_names

        def dim(axis):
            if axis not in names:
                return None
            p = x.placements[names.index(axis)]
            return p.dim if isinstance(p, Shard) else None

        return LeafLayout(dim("data"), self, dim("model"))


class LeafLayout:
    """How one leaf lies on a mesh: ``dim`` is the tensor dim split evenly
    over the "data" ranks and ``mdim`` the one split over the "model"
    ranks, None where the ranks of that axis hold it whole. The data-axis
    collectives a step makes for it (the model axis's are ``model``'s,
    called with ``mdim``)."""

    def __init__(self, dim: Optional[int], axis: DataAxis,
                 mdim: Optional[int] = None):
        self.dim, self.axis, self.mdim = dim, axis, mdim

    @property
    def model(self) -> ModelAxis:
        return self.axis.model

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The tensor whole over "data" from every data rank's shard (its
        model shard stays this rank's); the shard itself when the leaf is
        not split on "data"."""
        if self.dim is None:
            return local
        return self.axis.whole(local, self.dim)

    def part(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's "data" shard of a tensor whole over "data" (a
        view)."""
        if self.dim is None:
            return whole
        return self.axis.part(whole, self.dim)

    def sum_part(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's "data" shard of the sum over the data ranks of a
        tensor each has its own of (reduce-scatter, in f32)."""
        return self.axis.sum_part(whole, self.dim)


class _Gathered(torch.autograd.Function):
    """A shard gathered whole over "data" for the forward; the backward
    gives this rank's shard of the sum over the data ranks of the
    gradient. First-order only: Hutchinson's double backward never
    reaches it, since its route gathers every leaf whole over "data"
    before the model runs (``launch.steps.make_train_step``)."""

    @staticmethod
    def forward(ctx, local, lay):
        ctx.lay = lay
        return lay.whole(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.lay.sum_part(grad), None


class _Observed(torch.autograd.Function):
    """A shard gathered whole over "data" for the forward, as
    ``_Gathered``; the backward stores this rank's own gradient of the
    whole slice (one silo's, not summed over the data ranks) in
    ``sink[key]`` and gives the shard none. First-order only, as
    ``_Gathered``: the Fisher observation's route."""

    @staticmethod
    def forward(ctx, local, lay, sink, key):
        ctx.sink, ctx.key = sink, key
        return lay.whole(local)

    @staticmethod
    def backward(ctx, grad):
        prev = ctx.sink.get(ctx.key)
        ctx.sink[ctx.key] = grad if prev is None else prev + grad
        return None, None, None, None


class LocalShard:
    """A rank's "data" shard of a split weight as the model receives it on
    a mesh: indexing takes one layer of a stacked leaf (the layer axis is
    never split), and the installed ``shard_layer_params`` gathers it.
    ``key`` names the slice for ``make_observation_gather``: the leaf's
    index, then the layer's."""

    __slots__ = ("local", "dim", "key")

    def __init__(self, local: torch.Tensor, dim: int, key: tuple = ()):
        self.local, self.dim, self.key = local, dim, key

    def __getitem__(self, i):
        if self.dim == 0:
            raise IndexError("a split weight's split dim cannot be indexed")
        return LocalShard(self.local[i], self.dim - 1, self.key + (int(i),))

    @property
    def requires_grad(self) -> bool:
        return self.local.requires_grad


def make_layer_param_constrainer(mesh):
    """The installed ``shard_layer_params`` on ``mesh``, called on each
    layer's slice inside the model's loop and on the weights outside the
    stacks: every ``LocalShard`` gathered whole over "data" on each rank,
    its gradient summed over the data ranks onto each rank's shard; other
    leaves as they are. A weight split over "model" stays this rank's
    shard: the layer computes on its own columns or rows. Under remat the
    gather is recomputed in the backward, so the peak holds one layer's
    gathered weights, not the stack's (the reason the reference pins the
    slice inside the scan)."""
    axis = DataAxis(mesh)

    def constrain(tree):
        return tree_map(
            lambda x: (_Gathered.apply(x.local, LeafLayout(x.dim, axis))
                       if isinstance(x, LocalShard) else x), tree)

    return constrain


def make_observation_gather(axis: DataAxis, sink: dict):
    """A ``shard_layer_params`` for one silo's curvature observation on a
    mesh: every ``LocalShard`` gathered whole over "data" a layer at a
    time, as ``make_layer_param_constrainer``'s, but its backward keeps
    this silo's gradient of each gathered slice, whole over "data", in
    ``sink`` under the shard's ``key`` (the refresh reads them leaf by
    leaf), where the step's own reduces it over the data ranks."""
    def constrain(tree):
        return tree_map(
            lambda x: (_Observed.apply(x.local, LeafLayout(x.dim, axis), sink,
                                       x.key)
                       if isinstance(x, LocalShard) else x), tree)

    return constrain


def make_activation_constraint(mesh):
    """The installed ``shard_act`` on ``mesh``: ``(x, kind) -> x``. Every
    rule of ``make_activation_sharder`` asks the batch over ("pod",
    "data") on dim 0, which is what a rank's own rows are. Over "model",
    "btf", "bthd" and "logits" are what the tensor-parallel layers compute
    (their own columns, heads or vocab rows), and "carry" keeps this
    rank's T / M rows of the residual between segments (``split_seq``;
    the next layer gathers T inside its checkpoint, ``models.common.
    gather_carry``), or all of them where T does not divide."""
    model = DataAxis(mesh).model

    def constrain(x, kind: str):
        if (kind == "carry" and model.world > 1
                and x.shape[1] % model.world == 0):
            return model.split_seq(x)
        return x

    return constrain


def make_model_axis(mesh) -> Optional[ModelAxis]:
    """The ``ModelAxis`` the models compute over on ``mesh``
    (``models.common.set_activation_sharder``'s third hook), or None
    where the axis is one rank: the step is then the data-axis step."""
    model = DataAxis(mesh).model
    return model if model.world > 1 else None


# the families the model axis lays out: GQA or MLA attention (the
# encoder-decoder's encoder and cross-attention too), Mamba mixers in the
# hybrid stack, xLSTM's mLSTM and sLSTM blocks
TP_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def check_model_axis(cfg, ext: dict) -> None:
    """Raise ``NotImplementedError`` for what a "model" axis wider than
    one rank cannot lay out, before any work: a family outside
    ``TP_FAMILIES``, or a width the axis does not divide where the rules
    would replicate a weight no layer computes whole: GQA's q and kv
    columns (the decoder's, whisper's encoder's and its cross-attention's);
    MLA's ``wo`` rows (heads x v_head_dim); a Mamba mixer's inner width Di
    (``conv``, ``wout``); xLSTM's d_model (the mLSTM's columns, both
    blocks' ``wout`` rows) and 4 d_model (the sLSTM's ``wx`` and ``wr``
    columns); d_ff wherever a dense MLP runs, and an MoE's d_ff where its
    experts do not split (the reference's tensor parallelism inside each
    expert). A vocab the axis does not divide is the rules' own case:
    the embedding (and the lm head) are replicated over "model", and
    every rank computes the whole lookup, logits, loss and argmax, whose
    gradient is then the same on each. So are the small widths that
    layers take whole (``gather_weight`` where split, ``copy_in`` where
    not): MLA's ``wuq`` columns and latent rank, the SSM state, the
    mLSTM's 2 H gate columns (``wif``). Hutchinson curvature is laid
    out wherever the first-order step is: the operators' backwards are
    differentiable again."""
    m = int(ext.get("model", 1))
    if m == 1:
        return
    kind = "mla" if cfg.attn_type == "mla" else cfg.family
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"{kind} ({cfg.name}) on a 'model' axis of {m} ranks: only the "
            f"families {TP_FAMILIES} are laid out over 'model'")
    kinds = layer_kinds(cfg)
    mixers, ffns = {k[0] for k in kinds}, {k[1] for k in kinds}
    widths = []
    if "attn" in mixers:
        widths += [("heads x head_dim", cfg.n_heads * cfg.hd),
                   ("kv_heads x head_dim", cfg.kv_heads * cfg.hd)]
    if "mla" in mixers:
        widths.append(("heads x v_head_dim",
                       cfg.n_heads * cfg.mla.v_head_dim))
    if "mamba" in mixers:
        widths.append(("Di (expand x d_model)",
                       cfg.mamba.expand * cfg.d_model))
    if mixers & {"mlstm", "slstm"}:
        widths.append(("d_model", cfg.d_model))
    if "slstm" in mixers:
        widths.append(("4 x d_model", 4 * cfg.d_model))
    if "mlp" in ffns or ("moe" in ffns and cfg.moe.num_experts % m):
        widths.append(("d_ff", cfg.d_ff))
    for what, width in widths:
        if width % m:
            raise NotImplementedError(
                f"{cfg.name}: {what} = {width} does not split over a "
                f"'model' axis of {m} ranks")


def _split_dims(spec: Spec) -> dict:
    """{axis name: the tensor dim ``spec`` splits over it}."""
    out = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[axis] = dim
    return out


def local_keep(mesh, ext: dict, axes=("data", "model")):
    """``keep(path, whole_shape, x)`` for ``Model.init_params``: the drawn
    leaf ``x`` (one layer of a stacked leaf, whose whole shape has the
    layer axis first) narrowed to this rank's shard on each of ``axes``
    that the leaf's rule splits, so a rank never holds more than one
    layer of the whole tree. The values are the whole draw's, sliced."""
    ranks = {a: (int(mesh.size(mesh.mesh_dim_names.index(a))),
                 int(mesh.get_local_rank(a)))
             for a in axes if a in mesh.mesh_dim_names}

    def keep(path: str, whole_shape, x: torch.Tensor) -> torch.Tensor:
        spec = param_spec(path, tuple(whole_shape), ext)
        lead = x.dim() - len(whole_shape)          # -1 for a layer's slice
        for axis, dim in _split_dims(spec).items():
            if axis not in ranks or ranks[axis][0] == 1:
                continue
            world, rank = ranks[axis]
            d = dim + lead
            size = x.shape[d] // world
            x = x.narrow(d, rank * size, size)
        return x.contiguous()

    return keep


def from_local_tree(local, mesh, specs, whole):
    """``local``'s tensors (each rank's shards) as DTensors on ``mesh``
    with the placements of ``specs`` and the shapes of ``whole`` (a tree
    like it of tensors or meta tensors), laid out without the whole tree
    on any rank."""
    from torch.distributed.tensor import DTensor

    def leaf(x, spec, w):
        if not isinstance(x, torch.Tensor):
            return x
        w = torch.empty(tuple(w.shape), device="meta")
        return DTensor.from_local(x, mesh, placements(mesh, spec),
                                  run_check=False, shape=w.shape,
                                  stride=w.stride())

    return _over(leaf, local, specs, whole)


def model_parts(tree, specs, model: ModelAxis):
    """Each leaf of ``tree`` (whole) narrowed to this rank's shard on the
    dim its spec splits over "model" (views); the others as they are.
    For a cache laid out by ``cache_specs``."""
    def leaf(x, spec):
        dim = _split_dims(spec).get("model")
        if dim is None or model.world == 1:
            return x
        return model.part(x, dim)

    return _over(leaf, tree, specs)
