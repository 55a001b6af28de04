"""FedNL-LS — Algorithm 3 (globalization by backtracking line search),
counterpart of ``repro.core.fednl_ls``.

The devices learn Hessians as in FedNL; the server takes the direction
d^k = -[H^k]_mu^{-1} grad f(x^k) and backtracks gamma^s until
f(x^k + gamma^s d^k) <= f(x^k) + c gamma^s <grad, d^k> (the devices
report f_i at each probe: one float each).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..engine.method import MethodBase, Oracles, register, round_draws
from .compressors import FLOAT_BITS, Compressor
from .fednl import FedNLState
from .linalg import project_psd, solve_newton_system
from .newton import backtracking


class FedNLLS(MethodBase):
    def __init__(self, value_fn: Callable, grad_fn: Callable,
                 hess_fn: Callable, compressor: Compressor,
                 alpha: float = 1.0, mu: float = 0.0, c: float = 0.5,
                 gamma: float = 0.5):
        self.value_fn = value_fn
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn
        self.comp = compressor
        self.alpha = alpha
        self.mu = mu
        self.c = c
        self.gamma = gamma

    def init(self, x0, n, h0=None, seed: int = 0, draws=None) -> FedNLState:
        if h0 is None:
            h0 = self.hess_fn(x0)
        return FedNLState(x=x0, h_local=h0, h_global=torch.mean(h0, dim=0),
                          step=0, draws=round_draws(draws, seed, x0))

    def step(self, state: FedNLState) -> FedNLState:
        n, d = state.h_local.shape[:2]
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.x.dtype)
        grads = self.grad_fn(state.x)
        hesses = self.hess_fn(state.x)
        payloads, _ = self._uplink_diff_payloads(hesses, state.h_local,
                                                 silo_draws)
        s_i = self._local_hessians(payloads, (d, d))

        grad = torch.mean(grads, dim=0)
        d_dir = -solve_newton_system(project_psd(state.h_global, self.mu),
                                     grad)
        t = backtracking(self.value_fn, state.x, d_dir, grad, c=self.c,
                         gamma=self.gamma)
        return FedNLState(
            x=torch.add(state.x, d_dir, alpha=t),
            h_local=state.h_local + self.alpha * s_i,
            h_global=state.h_global + self.alpha * self._server_aggregate(
                payloads, (d, d)),
            step=state.step + 1, draws=state.draws)

    def bits_per_round(self, d: int) -> int:
        from ..wire.report import analytic_bits

        # f_i + gradient + S_i
        return FLOAT_BITS + d * FLOAT_BITS + analytic_bits(self.comp, (d, d))

    def init_bits(self, d: int) -> int:
        """H_i^0 = hess_i(x0) shipped once (as in FedNL)."""
        return d * (d + 1) // 2 * FLOAT_BITS


@register("fednl-ls")
def _make_fednl_ls(oracles: Oracles, compressor, **params):
    return FedNLLS(oracles.value, oracles.grad, oracles.hess, compressor,
                   **params)
