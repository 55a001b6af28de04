"""Reference Newton-type methods: N, NS, N0, N0-LS (paper Sec. 3.5,
App. G), counterpart of ``repro.core.newton``.

  Newton (N):        C = I, alpha = 1, H_i^0 = 0          (exact Hessians)
  Newton-Star (NS):  C = 0, alpha = 0, H_i^0 = hess_i(x*) (oracle)
  Newton-Zero (N0):  C = 0, alpha = 0, H_i^0 = hess_i(x0)
  N0-LS:             N0 direction + backtracking line search

``backtracking`` is a host loop: each probe's value is read on the host
(one sync) and the loop stops at the first accepted step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..engine.method import MethodBase, Oracles, register
from .compressors import FLOAT_BITS
from .linalg import project_psd, solve_newton_system


class SimpleState(NamedTuple):
    x: torch.Tensor
    h: torch.Tensor  # fixed or current (d, d) Hessian estimate


class Newton(MethodBase):
    """Classical Newton on the averaged problem (uncompressed)."""

    def __init__(self, grad_fn, hess_fn):
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn

    def init(self, x0, n: int = 0, seed: int = 0) -> SimpleState:
        # h is recomputed from x every step
        d = x0.shape[0]
        return SimpleState(x=x0, h=torch.zeros((d, d), dtype=x0.dtype,
                                               device=x0.device))

    def step(self, state: SimpleState) -> SimpleState:
        g = torch.mean(self.grad_fn(state.x), dim=0)
        h = torch.mean(self.hess_fn(state.x), dim=0)
        return SimpleState(x=state.x - solve_newton_system(h, g), h=h)

    def bits_per_round(self, d: int) -> int:
        # gradient + full symmetric Hessian per device per round
        return d * FLOAT_BITS + d * (d + 1) // 2 * FLOAT_BITS


class FixedHessian(MethodBase):
    """NS (h_fixed = hess(x*)) and N0 (h_fixed = None: the mean local
    Hessian at x0); eq. (9)/(55)."""

    def __init__(self, grad_fn, h_fixed: Optional[torch.Tensor] = None,
                 hess_fn=None, mu: float = 0.0):
        if h_fixed is None and hess_fn is None:
            raise ValueError("FixedHessian needs h_fixed or hess_fn")
        self.grad_fn = grad_fn
        self.h_fixed = h_fixed
        self.hess_fn = hess_fn
        self.mu = mu

    def _h_eff(self, x0):
        h = self.h_fixed
        if h is None:
            h = torch.mean(self.hess_fn(x0), dim=0)
        return project_psd(h, self.mu) if self.mu > 0 else h

    def init(self, x0, n: int = 0, seed: int = 0) -> SimpleState:
        return SimpleState(x=x0, h=self._h_eff(x0))

    def step(self, state: SimpleState) -> SimpleState:
        g = torch.mean(self.grad_fn(state.x), dim=0)
        return state._replace(x=state.x - solve_newton_system(state.h, g))

    def bits_per_round(self, d: int) -> int:
        return d * FLOAT_BITS  # gradient only — the Hessian never moves

    def init_bits(self, d: int) -> int:
        """The one-time cost of shipping the frozen Hessian estimate."""
        return d * (d + 1) // 2 * FLOAT_BITS


def backtracking(value_fn, x, d_dir, g, c: float = 0.5, gamma: float = 0.5,
                 max_steps: int = 30) -> float:
    """gamma^s for the first s < ``max_steps`` with
    f(x + gamma^s d) <= f(x) + c gamma^s <g, d> (Alg. 3, line 12), t
    made by repeated multiplication; gamma^max_steps if none passes."""
    f0 = float(value_fn(x))
    slope = float(torch.dot(g, d_dir))
    t = 1.0
    for _ in range(max_steps):
        if float(value_fn(torch.add(x, d_dir, alpha=t))) <= f0 + c * t * slope:
            return t
        t *= gamma
    return t


class N0LS(FixedHessian):
    """Newton-Zero direction + backtracking line search (N0-LS)."""

    def __init__(self, value_fn, grad_fn, h_fixed: Optional[torch.Tensor] = None,
                 hess_fn=None, mu: float = 0.0, c: float = 0.5,
                 gamma: float = 0.5):
        super().__init__(grad_fn, h_fixed=h_fixed, hess_fn=hess_fn, mu=mu)
        self.value_fn = value_fn
        self.c = c
        self.gamma = gamma

    def step(self, state: SimpleState) -> SimpleState:
        g = torch.mean(self.grad_fn(state.x), dim=0)
        d_dir = -solve_newton_system(state.h, g)
        t = backtracking(self.value_fn, state.x, d_dir, g, c=self.c,
                         gamma=self.gamma)
        return state._replace(x=torch.add(state.x, d_dir, alpha=t))

    def bits_per_round(self, d: int) -> int:
        return FLOAT_BITS + d * FLOAT_BITS  # f_i probe + gradient


# -- function wrappers over the Method classes --------------------------------


def newton_step(x, grad_fn, hess_fn):
    """Classical Newton on the averaged problem."""
    g = torch.mean(grad_fn(x), dim=0)
    h = torch.mean(hess_fn(x), dim=0)
    return x - solve_newton_system(h, g)


def newton_run(x0, grad_fn, hess_fn, num_rounds: int):
    """Returns (x after ``num_rounds`` steps, (num_rounds + 1, d)
    iterate history with x0 first)."""
    final, xs = Newton(grad_fn, hess_fn).run(x0, 0, num_rounds)
    return final.x, xs


def fixed_hessian_run(x0, h_fixed, grad_fn, num_rounds: int, mu: float = 0.0):
    """NS (h_fixed = hess(x*)) and N0 (h_fixed = hess(x0))."""
    final, xs = FixedHessian(grad_fn, h_fixed=h_fixed, mu=mu).run(
        x0, 0, num_rounds)
    return final.x, xs


def n0_ls_run(x0, h_fixed, value_fn, grad_fn, num_rounds: int,
              mu: float = 0.0, c: float = 0.5, gamma: float = 0.5):
    """Newton-Zero with backtracking line search (N0-LS)."""
    final, xs = N0LS(value_fn, grad_fn, h_fixed=h_fixed, mu=mu, c=c,
                     gamma=gamma).run(x0, 0, num_rounds)
    return final.x, xs


@register("newton")
def _make_newton(oracles: Oracles, compressor=None, **params):
    return Newton(oracles.grad, oracles.hess)


@register("n0")
def _make_n0(oracles: Oracles, compressor=None, **params):
    return FixedHessian(oracles.grad, hess_fn=oracles.hess, **params)


@register("ns")
def _make_ns(oracles: Oracles, compressor=None, *, h_fixed, **params):
    # NS needs the oracle Hessian at x*: pass it as h_fixed
    return FixedHessian(oracles.grad, h_fixed=h_fixed, **params)


@register("n0-ls")
def _make_n0_ls(oracles: Oracles, compressor=None, **params):
    return N0LS(oracles.value, oracles.grad, hess_fn=oracles.hess, **params)
