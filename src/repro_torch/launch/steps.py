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
from ..second_order import adamw, apply_updates, fednl_precond, sgd
from ..tree import tree_leaves, tree_map, tree_unflatten


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
    """Hutchinson probes as a draw source: ``(step, silo, params) -> z``,
    a tree like ``params`` of +-1 in each leaf's dtype and on its device,
    drawn leaf by leaf from a CPU ``torch.Generator`` seeded from
    (seed, step, silo). The reference draws from ``jax.random`` keys
    folded the same way; torch cannot reproduce those draws."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def __call__(self, step: int, silo: int, params):
        mixed = np.random.SeedSequence([self.seed, int(step), int(silo)])
        gen = torch.Generator().manual_seed(
            int(mixed.generate_state(1, np.uint64)[0]) >> 1)

        def one(p):
            bits = torch.randint(0, 2, tuple(p.shape), generator=gen,
                                 dtype=torch.int8)
            return (2 * bits - 1).to(device=p.device, dtype=p.dtype)

        return tree_map(one, params)


def value_and_grad(model: Model, params, batch, create_graph: bool = False):
    """(loss, the leaves the gradient is taken at, the gradient leaves in
    ``tree_leaves`` order). ``create_graph`` keeps the gradient's graph
    for a second backward."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, create_graph=create_graph)
    return loss, leaves, grads


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
                    hvp: bool = False, probe_seed: int = 0, probes=None):
    """``microbatches > 1`` splits the global batch and accumulates the
    gradients in f32 over the pieces, one piece's activations alive at a
    time; the sum is divided and cast to each parameter's dtype.

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
    draw source (``RademacherProbes(probe_seed)`` by default)."""
    second_order = (getattr(optimizer, "refresh", None) is not None
                    and refresh_every >= 1)
    probes = RademacherProbes(probe_seed) if probes is None else probes

    def split(batch, parts: int, i: int):
        size = tree_leaves(batch)[0].shape[0] // parts
        return tree_map(lambda x: x[i * size:(i + 1) * size], batch)

    def observe_and_refresh(state, params, batch):
        """One refresh: an observation per silo shard, stacked on a
        leading silo axis, then ``optimizer.refresh``."""
        stack = None
        for i in range(n_silos):
            b_i = split(batch, n_silos, i)
            if hvp:
                z = probes(state.step, i, params)
                g_i, hz = grad_and_hvp(model, params, b_i, z)
                obs = optimizer.observe(g_i, params, hvp=(z, hz))
                del z, hz
            else:
                _, _, g = value_and_grad(model, params, b_i)
                g_i = tree_unflatten(params, list(g))
                obs = optimizer.observe(g_i)
            del g_i
            leaves = tree_leaves(obs)
            if stack is None:
                stack = [torch.empty((n_silos,) + tuple(o.shape),
                                     dtype=o.dtype, device=o.device)
                         for o in leaves]
            for s, o in zip(stack, leaves):
                s[i].copy_(o)
            del obs, leaves
        return optimizer.refresh(state, tree_unflatten(params, stack))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, _, g = value_and_grad(model, params, batch)
            loss = loss.detach()
            grads = tree_unflatten(params, list(g))
        else:
            loss = None
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            for j in range(microbatches):
                loss_j, _, g = value_and_grad(
                    model, params, split(batch, microbatches, j))
                loss_j = loss_j.detach()
                loss = loss_j if loss is None else loss + loss_j
                for a, gj in zip(acc, g):
                    a.add_(gj.to(torch.float32))
                del g
            loss = loss / microbatches
            grads = tree_unflatten(params, [
                (a / microbatches).to(p.dtype)
                for a, p in zip(acc, tree_leaves(params))])
            del acc

        refreshed = 0.0
        if second_order:
            b0 = tree_leaves(batch)[0].shape[0]
            if b0 % n_silos:
                raise ValueError(
                    f"global batch {b0} must divide into n_silos={n_silos}")
            if opt_state.step % refresh_every == 0:
                opt_state = observe_and_refresh(opt_state, params, batch)
                refreshed = 1.0
            updates, opt_state = optimizer.precondition(grads, opt_state,
                                                        params)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "curv_refreshed": refreshed}

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
