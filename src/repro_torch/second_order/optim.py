"""First-order optimizers on parameter trees, counterpart of
``repro.second_order.optim``:

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``params`` is a nested dict/list of tensors (``repro_torch.tree``).
Moments are stored in the parameters' dtype unless ``moment_dtype``
says otherwise; the arithmetic is f32 where the reference's is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..tree import tree_map


class OptState(NamedTuple):
    step: int
    mu: Any          # first moment (or momentum), a tree or None
    nu: Any          # second moment, a tree or None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``update`` is ``(grads, state, params, observations=None) ->
    (updates, state)``; first-order optimizers ignore ``observations``.

    A second-order optimizer also binds the amortized hooks:
    ``observe(grads, params=None, hvp=None) -> obs`` (curvature
    observation per tensor), ``refresh(state, observations) -> state``
    (learn curvature, the expensive phase) and
    ``precondition(grads, state, params) -> (updates, state)`` (the cheap
    step from stored curvature), and ``uplink_bits(params, n_silos=1)
    -> int``, the host-side wire cost of one curvature refresh."""

    init: Callable
    update: Callable
    observe: Optional[Callable] = None
    refresh: Optional[Callable] = None
    precondition: Optional[Callable] = None
    uplink_bits: Optional[Callable] = None


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(0, mu, None)

    def update(grads, state, params, observations=None):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            upd = tree_map(lambda m: -lr * m, mu)
        else:
            mu = None
            upd = tree_map(lambda g: -lr * g, grads)
        return upd, OptState(state.step + 1, mu, None)

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          moment_dtype: Optional[torch.dtype] = None) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=moment_dtype or p.dtype)

        return OptState(0, tree_map(z, params), tree_map(z, params))

    def update(grads, state, params, observations=None):
        step = state.step + 1
        # bias corrections in f32, as the reference's f32 power
        t = torch.tensor(float(step), dtype=torch.float32)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m_new = b1 * m.to(torch.float32) + (1 - b1) * g32
            v_new = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
            mhat = m_new / c1.to(g.device)
            vhat = v_new / c2.to(g.device)
            u = -lr * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.to(torch.float32))
            return u.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        out = tree_map(upd, grads, state.mu, state.nu, params)
        pick = [tree_map(lambda o: o[i], out) for i in range(3)]
        return pick[0], OptState(step, pick[1], pick[2])

    return Optimizer(init, update)
