"""Train, prefill and serve steps shared by the trainer, the server and
the smoke run, the counterparts of ``src/repro/launch/steps.py``.

``make_train_step``  : (params, opt_state, batch) -> (params, opt_state, metrics)
``make_prefill``     : (params, batch) -> logits
``make_serve_step``  : (params, cache, token, pos) -> (logits, cache)

PyTorch runs eagerly, so a step is a Python function (the reference
jits it). Optimizer choice: 'adamw' | 'sgd' | 'fednl' (the paper's
technique as a diagonal curvature preconditioner,
``second_order/fednl_precond.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import Model
from ..models.common import installed_hooks, model_axis, set_activation_sharder
from ..second_order import adamw, apply_updates, fednl_precond, sgd
from ..tree import tree_leaves, tree_map, tree_unflatten
from .mesh import extents
from .sharding import (DataAxis, LocalShard, check_model_axis, like_tree,
                       local_tree, make_observation_gather)


def make_optimizer(name: str, lr: float, moment_dtype=None, **kw):
    if name == "adamw":
        return adamw(lr, moment_dtype=moment_dtype)
    if name == "sgd":
        return sgd(lr, momentum=0.9)
    if name == "fednl":
        # update, and the observe/refresh/precondition protocol that
        # make_train_step's curvature phase drives
        return fednl_precond(lr, **kw)
    raise ValueError(name)


class RademacherProbes:
    """Hutchinson probes as a draw source: ``(step, silo, params[,
    lays]) -> z``, a tree like ``params`` of +-1 in each leaf's dtype and
    on its device, drawn leaf by leaf from a CPU ``torch.Generator``
    seeded from (seed, step, silo). The reference draws from
    ``jax.random`` keys folded the same way; torch cannot reproduce those
    draws. ``lays`` (each leaf's ``LeafLayout``, on a "model" axis): a
    leaf split over "model" (``mdim``) is this rank's shard, so it is
    drawn at its whole shape, M times the shard's on ``mdim``, and this
    rank keeps its block. Every leaf is then drawn as one process draws
    it, in the same order, so a rank's z is its block of one process's
    z bit for bit, and a leaf held whole has the same z on every rank."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def __call__(self, step: int, silo: int, params, lays=None):
        mixed = np.random.SeedSequence([self.seed, int(step), int(silo)])
        gen = torch.Generator().manual_seed(
            int(mixed.generate_state(1, np.uint64)[0]) >> 1)

        def one(p, lay=None):
            shape = list(p.shape)
            split = lay is not None and lay.mdim is not None \
                and lay.model.world > 1
            if split:
                shape[lay.mdim] *= lay.model.world
            bits = torch.randint(0, 2, tuple(shape), generator=gen,
                                 dtype=torch.int8)
            if split:
                bits = lay.model.part(bits, lay.mdim)
            return (2 * bits - 1).to(device=p.device, dtype=p.dtype)

        if lays is None:
            return tree_map(one, params)
        return tree_map(one, params, lays)


def value_and_grad(model: Model, params, batch, create_graph: bool = False,
                   split_dims=None):
    """(loss, the leaves the gradient is taken at, the gradient leaves in
    ``tree_leaves`` order). ``create_graph`` keeps the gradient's graph
    for a second backward. ``split_dims`` (one entry per leaf, on a
    mesh): a leaf whose entry is a dim is this rank's shard of a weight
    split on that dim; the model receives it as a ``LocalShard``, which
    the installed ``shard_layer_params`` gathers, and its gradient is
    this rank's shard of the sum over the ranks."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    inputs = leaves if split_dims is None else [
        x if d is None else LocalShard(x, d) for x, d in zip(leaves, split_dims)]
    loss = model.loss_fn(tree_unflatten(params, inputs), batch)
    grads = torch.autograd.grad(loss, leaves, create_graph=create_graph)
    return loss, leaves, grads


def silo_gradients(model: Model, params, batch, lays) -> list:
    """One silo's gradient on a mesh, taken through the per-layer gather
    as the step's own gradient is (a "data"-split leaf reaches the model
    as a ``LocalShard``, gathered a layer at a time inside the remat),
    but with ``sharding.make_observation_gather`` installed in place of
    the step's hook: its backward keeps this silo's gradient of each
    gathered slice whole over "data" instead of reducing it over the data
    ranks. ``lays``: each leaf's ``LeafLayout``. Returns one entry a leaf
    in ``tree_leaves`` order: the gradient, whole over "data" and this
    rank's over "model", or for a stacked leaf split over "data" its
    layers' gradients in a list (no stack is made)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    sink = {}
    inputs = [x if lay.dim is None else LocalShard(x, lay.dim, (j,))
              for j, (x, lay) in enumerate(zip(leaves, lays))]
    hooks = installed_hooks()
    set_activation_sharder(hooks[0], make_observation_gather(lays[0].axis,
                                                             sink), hooks[2])
    try:
        loss = model.loss_fn(tree_unflatten(params, inputs), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        set_activation_sharder(*hooks)
    del loss
    out = []
    for j, (x, lay, g) in enumerate(zip(leaves, lays, grads)):
        if lay.dim is None:
            out.append(torch.zeros_like(x) if g is None else g)
        elif (j,) in sink:
            out.append(sink.pop((j,)))
        else:
            shape = list(x.shape[1:])
            shape[lay.dim - 1] *= lay.axis.world
            layers = [sink.pop((j, i), None) for i in range(x.shape[0])]
            out.append([x.new_zeros(shape) if gi is None else gi
                        for gi in layers])
    return out


def grad_and_hvp(model: Model, params, batch, z):
    """The gradient and the Hessian-vector product Hz at ``params``, as
    trees like ``params``: Hz by double backward (``autograd.grad`` of the
    gradient with ``z`` as its output gradient). The reference takes the
    same product as ``jax.jvp`` of ``jax.grad``."""
    _, leaves, grads = value_and_grad(model, params, batch, create_graph=True)
    hz = torch.autograd.grad(grads, leaves, grad_outputs=tree_leaves(z),
                             allow_unused=True)
    hz = [torch.zeros_like(leaf) if h is None else h
          for h, leaf in zip(hz, leaves)]
    return (tree_unflatten(params, [g.detach() for g in grads]),
            tree_unflatten(params, hz))


def make_train_step(model: Model, optimizer, microbatches: int = 1,
                    refresh_every: int = 1, n_silos: int = 1,
                    hvp: bool = False, probe_seed: int = 0, probes=None,
                    mesh=None, donate: bool = False):
    """``microbatches > 1`` splits the batch and accumulates the
    gradients in f32 over the pieces, one piece's activations alive at a
    time; the sum is divided and cast to each parameter's dtype. A batch
    that ``microbatches`` does not divide raises ``ValueError`` before any
    work (the reference's reshape raises too).

    Second-order optimizers (``optimizer.refresh`` set: fednl) get a
    curvature phase: every ``refresh_every`` steps, by
    ``opt_state.step``, the batch is split along its leading axis into
    ``n_silos`` shards (the mesh's data axis in the train driver: each
    shard plays one FedNL silo) and each gives one curvature observation,
    the empirical Fisher g^2, or with ``hvp`` Hutchinson's z * Hz. The
    silo-stacked observations go through ``optimizer.refresh`` (per-silo
    Block-Top-K diff payloads and their payload-space server mean: K1
    and K4 on a card), and every step's update is
    ``optimizer.precondition`` from the stored curvature. First-order
    optimizers take ``optimizer.update``. ``probes`` is the probes'
    draw source (``RademacherProbes(probe_seed)`` by default). The
    refresh runs before the step's own gradient (they share nothing).

    ``mesh`` (a ``("data", "model")`` mesh): every data rank runs the
    step on its own rows of the global batch, with ``params`` and
    ``opt_state`` laid out by the rules (``sharding.from_local_tree``)
    and the hooks installed
    (``models.common.set_activation_sharder`` with
    ``make_activation_constraint``, ``make_layer_param_constrainer`` and
    ``make_model_axis`` of the mesh). The forward gathers each
    "data"-split weight a layer at a time; the gradient is the mean over
    the data ranks, each such leaf's reduced onto its shards in the
    backward and the others' in one all-reduce. The M ranks of one data
    index compute through the tensor-parallel layers together: a leaf
    split over "model" has this rank's shard of the gradient, and every
    other leaf the same whole gradient on each of them, so nothing is
    summed over "model". Each data index plays ``n_silos / W`` silos
    (one in the driver): each silo's gradient is taken on its rows
    through the same per-layer gather, whose backward keeps it whole
    over "data" (``silo_gradients``), before any reduction across ranks,
    and the refresh takes it leaf by leaf (``refresh_grads``): g^2 in
    f32, and for a stacked leaf whose layers lie on 128-row tile bounds
    a layer slice at a time, H's slice gathered whole over "data" for K1
    (on the rank's model shard where it lies on tile bounds) and the
    silos' payloads gathered in silo order for K4, each rank keeping its
    shard of H. Neither the weights nor the observations are held whole
    over "data" as a tree; H and l equal the whole-tree route's bit for
    bit. Hutchinson curvature (``hvp``) keeps that route: its probes and
    double backward run on the weights gathered whole over "data", the
    observations stacked, then ``optimizer.refresh(..., layout=)``. Over
    a "model" axis the double backward runs through the tensor-parallel
    layers (each operator's backward is differentiable again), each
    rank's probe is its block of one process's (``RademacherProbes`` with
    the layouts), so Hz and z * Hz are this rank's model shards, and the
    refresh runs K1 on a shard that lies on 128-wide tile bounds, then
    K4. On one rank this is the step without a mesh, bit for bit, and on
    a model axis of one rank the data-axis step. A family or width the
    model axis does not lay out raises ``NotImplementedError`` here,
    before any work (``sharding.check_model_axis``).

    ``donate``: the step may overwrite the tensors of ``params`` and
    ``opt_state`` (the caller drops them, as JAX's ``donate_argnums``):
    fednl's H and momentum and the params are updated in place, with the
    same arithmetic, so one copy of the state is alive, not two."""
    second_order = (getattr(optimizer, "refresh", None) is not None
                    and refresh_every >= 1)
    probes = RademacherProbes(probe_seed) if probes is None else probes
    if mesh is not None:
        check_model_axis(model.cfg, extents(mesh))
    axis = None if mesh is None else DataAxis(mesh)
    world, rank = (1, 0) if axis is None else (axis.world, axis.rank)
    tp = None if axis is None or axis.model.world == 1 else axis.model
    if n_silos % world:
        raise ValueError(f"n_silos={n_silos} must divide over {world} ranks")
    local_silos = n_silos // world
    fednl_kw = {"donate": True} if donate else {}
    by_grads = getattr(optimizer, "refresh_grads", None) is not None

    def split(batch, parts: int, i: int):
        size = tree_leaves(batch)[0].shape[0] // parts
        return tree_map(lambda x: x[i * size:(i + 1) * size], batch)

    def observe_and_refresh(state, params, batch, lays):
        """One refresh: on a mesh with Fisher curvature, each silo's
        gradient through the per-layer gather (``silo_gradients``), then
        ``optimizer.refresh_grads`` leaf by leaf. Else an observation per
        silo of this rank's rows, on the weights whole over "data",
        stacked on a leading silo axis, then ``optimizer.refresh`` (over
        the ranks with ``lays``)."""
        if lays is not None and not hvp and by_grads:
            lay_leaves = tree_leaves(lays)
            grads = [silo_gradients(model, params,
                                    split(batch, local_silos, i), lay_leaves)
                     for i in range(local_silos)]
            return optimizer.refresh_grads(state, grads, lays, **fednl_kw)
        whole = (params if lays is None else
                 tree_map(lambda p, lay: lay.whole(p), params, lays))
        per_silo = []
        for i in range(local_silos):
            silo = rank * local_silos + i
            b_i = split(batch, local_silos, i)
            if hvp:
                z = (probes(state.step, silo, whole) if tp is None
                     else probes(state.step, silo, whole, lays))
                g_i, hz = grad_and_hvp(model, whole, b_i, z)
                obs = optimizer.observe(g_i, whole, hvp=(z, hz))
                del z, hz
            else:
                _, _, g = value_and_grad(model, whole, b_i)
                g_i = tree_unflatten(params, list(g))
                del g
                obs = optimizer.observe(g_i)
            del g_i
            per_silo.append(tree_leaves(obs))
            del obs
        del whole
        if local_silos == 1:          # K1 reads contiguous observations
            stack = [o.unsqueeze(0).contiguous() for o in per_silo[0]]
        else:
            stack = [torch.stack(col) for col in zip(*per_silo)]
        del per_silo
        obs = tree_unflatten(params, stack)
        del stack
        if lays is None:
            return optimizer.refresh(state, obs, **fednl_kw)
        return optimizer.refresh(state, obs, layout=lays, **fednl_kw)

    def train_step(params, opt_state, batch):
        b0 = tree_leaves(batch)[0].shape[0]
        if b0 % microbatches:
            raise ValueError(f"global batch {b0 * world} must divide into "
                             f"{world} rank(s) x microbatches={microbatches}")
        if second_order and b0 % local_silos:
            raise ValueError(f"global batch {b0 * world} must divide into "
                             f"n_silos={n_silos}")
        if tp is not None and model_axis() is None:
            raise RuntimeError("a mesh with a 'model' axis needs the hooks "
                               "installed: set_activation_sharder(..., "
                               "make_model_axis(mesh))")
        lays = None if axis is None else tree_map(axis.layout, params)
        lay_leaves = None if lays is None else tree_leaves(lays)
        dims = None if lays is None else [lay.dim for lay in lay_leaves]
        p_loc, state = local_tree(params), local_tree(opt_state)
        p_leaves = tree_leaves(p_loc)

        refreshed = 0.0
        if second_order and state.step % refresh_every == 0:
            state = observe_and_refresh(state, p_loc, batch, lays)
            refreshed = 1.0

        if microbatches == 1 and world == 1:
            loss, _, g = value_and_grad(model, p_loc, batch, split_dims=(
                None if tp is None else dims))
            loss = loss.detach()
            grads = list(g)
        else:
            loss = None
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in p_leaves]
            for j in range(microbatches):
                loss_j, _, g = value_and_grad(
                    model, p_loc, split(batch, microbatches, j),
                    split_dims=dims)
                loss_j = loss_j.detach()
                loss = loss_j if loss is None else loss + loss_j
                for a, gj in zip(acc, g):
                    a.add_(gj.to(torch.float32))
                del g
            if world > 1:
                loss, = axis.sum([loss], [True])
                acc = axis.sum(acc, [d is None for d in dims])
            parts = microbatches * world
            loss = loss / parts
            grads = [(a / parts).to(p.dtype) for a, p in zip(acc, p_leaves)]
            del acc
        grads = tree_unflatten(p_loc, grads)

        if second_order:
            updates, state = optimizer.precondition(grads, state, p_loc,
                                                    **fednl_kw)
        else:
            updates, state = optimizer.update(grads, state, p_loc)
        if donate:
            p_loc = tree_map(lambda p, u: p.add_(u), p_loc, updates)
        else:
            p_loc = apply_updates(p_loc, updates)
        del updates
        sums = [torch.sum(torch.square(g.to(torch.float32)))
                for g in tree_leaves(grads)]
        if world > 1:
            sums = axis.sum(sums, [d is not None for d in dims])
        if tp is not None:
            sums = tp.sum(sums, [lay.mdim is not None for lay in lay_leaves])
        gnorm = torch.sqrt(sum(sums))
        return (like_tree(p_loc, params), like_tree(state, opt_state),
                {"loss": loss, "grad_norm": gnorm,
                 "curv_refreshed": refreshed})

    return train_step


def make_prefill(model: Model):
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill


def make_serve_step(model: Model):
    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return serve_step
