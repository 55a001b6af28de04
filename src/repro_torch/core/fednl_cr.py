"""FedNL-CR — Algorithm 4 (globalization by cubic regularization),
counterpart of ``repro.core.fednl_cr``.

The devices learn Hessians as in FedNL. The server steps by

  h^k = argmin_h <grad, h> + 1/2 <(H^k + l^k I) h, h> + (L*/6) ||h||^3

and x^{k+1} = x^k + h^k. H_i^0 = 0 is the paper's initialization.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..engine.method import MethodBase, Oracles, register, round_draws
from .compressors import FLOAT_BITS, Compressor
from .fednl import FedNLState
from .linalg import solve_cubic_subproblem


class FedNLCR(MethodBase):
    def __init__(self, grad_fn: Callable, hess_fn: Callable,
                 compressor: Compressor, l_star: float, alpha: float = 1.0):
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn
        self.comp = compressor
        self.l_star = l_star
        self.alpha = alpha

    def init(self, x0, n, h0=None, seed: int = 0, draws=None) -> FedNLState:
        d = x0.shape[0]
        if h0 is None:
            h0 = torch.zeros((n, d, d), dtype=x0.dtype, device=x0.device)
        return FedNLState(x=x0, h_local=h0, h_global=torch.mean(h0, dim=0),
                          step=0, draws=round_draws(draws, seed, x0))

    def step(self, state: FedNLState) -> FedNLState:
        n, d = state.h_local.shape[:2]
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.x.dtype)
        grads = self.grad_fn(state.x)
        hesses = self.hess_fn(state.x)
        payloads, l_i = self._uplink_diff_payloads(hesses, state.h_local,
                                                   silo_draws)
        s_i = self._local_hessians(payloads, (d, d))

        grad = torch.mean(grads, dim=0)
        eye = torch.eye(d, dtype=state.x.dtype, device=state.x.device)
        h_corr = state.h_global + torch.mean(l_i) * eye
        x_new = state.x + solve_cubic_subproblem(grad, h_corr, self.l_star)
        return FedNLState(
            x=x_new,
            h_local=state.h_local + self.alpha * s_i,
            h_global=state.h_global + self.alpha * self._server_aggregate(
                payloads, (d, d)),
            step=state.step + 1, draws=state.draws)

    def bits_per_round(self, d: int) -> int:
        from ..wire.report import analytic_bits

        return d * FLOAT_BITS + analytic_bits(self.comp, (d, d)) + FLOAT_BITS


@register("fednl-cr")
def _make_fednl_cr(oracles: Oracles, compressor, **params):
    return FedNLCR(oracles.grad, oracles.hess, compressor, **params)
