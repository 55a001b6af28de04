"""FedNL — Algorithm 1 (Federated Newton Learn), counterpart of
``repro.core.fednl``.

One communication round:

  devices i = 1..n:
      S_i^k = C(H2_i(x^k) - H_i^k),  l_i^k = ||H_i^k - H2_i(x^k)||_F
      send grad_i(x^k), S_i^k, l_i^k;  H_i^{k+1} = H_i^k + alpha S_i^k
  server:
      grad = mean_i grad_i ; S = mean_i S_i ; l = mean_i l_i
      H^{k+1} = H^k + alpha S
      Option 1: x^{k+1} = x^k - [H^k]_mu^{-1} grad
      Option 2: x^{k+1} = x^k - (H^k + l^k I)^{-1} grad

The per-silo state is stacked on a leading silo axis; the server means
S in payload space (``Compressor.aggregate``). A randomized compressor
takes each silo's draw from the state's round-draw source. With a
process ``group`` the silo axis holds this rank's silos and each mean
is reduced over the ranks (``core/federated.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..engine.method import MethodBase, Oracles, register, round_draws
from .compressors import FLOAT_BITS, Compressor
from .linalg import project_psd, solve_newton_system


class FedNLState(NamedTuple):
    x: torch.Tensor         # (d,) global model
    h_local: torch.Tensor   # (n, d, d) local Hessian estimates H_i
    h_global: torch.Tensor  # (d, d) server estimate H = mean_i H_i
    step: int               # iteration counter
    draws: Any              # round-draw source


class FedNL(MethodBase):
    """Vanilla FedNL. ``option`` in {1, 2}; ``mu`` is used by Option 1.

    grad_fn: x -> (n, d) per-silo gradients
    hess_fn: x -> (n, d, d) per-silo Hessians
    group:   a ``torch.distributed`` process group over which the silos
             are split (the reference's ``axis_name``); None on one
             process
    """

    def __init__(self, grad_fn: Callable, hess_fn: Callable,
                 compressor: Compressor, alpha: float = 1.0, option: int = 1,
                 mu: float = 0.0, group=None):
        if option not in (1, 2):
            raise ValueError(f"option must be 1 or 2, got {option}")
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn
        self.comp = compressor
        self.alpha = alpha
        self.option = option
        self.mu = mu
        self.group = group

    def _mean(self, v: torch.Tensor) -> torch.Tensor:
        return self._server_reduce(torch.mean(v, dim=0))

    def init(self, x0: torch.Tensor, n: int,
             h0: Optional[torch.Tensor] = None, seed: int = 0,
             draws=None) -> FedNLState:
        """h0: (n, d, d) initial local estimates; default the exact local
        Hessians at x0 (the paper's initialization)."""
        if h0 is None:
            h0 = self.hess_fn(x0)
        return FedNLState(x=x0, h_local=h0, h_global=torch.mean(h0, dim=0),
                          step=0, draws=round_draws(draws, seed, x0))

    def step(self, state: FedNLState) -> FedNLState:
        n = state.h_local.shape[0]
        shape = tuple(state.h_local.shape[1:])
        silo_draws = state.draws.silos(self.comp, n, shape, state.x.dtype)
        grads = self.grad_fn(state.x)                     # (n, d)
        hesses = self.hess_fn(state.x)                    # (n, d, d)

        payloads, l_i = self._uplink_diff_payloads(hesses, state.h_local,
                                                   silo_draws)
        s_i = self._local_hessians(payloads, shape)

        grad = self._mean(grads)
        s_mean = self._server_aggregate(payloads, shape)
        l_mean = self._mean(l_i)

        h_global = state.h_global + self.alpha * s_mean
        h_local = state.h_local + self.alpha * s_i

        # the model update uses the current H^k (paper lines 11-12)
        if self.option == 1:
            h_eff = project_psd(state.h_global, self.mu)
        else:
            eye = torch.eye(state.x.shape[0], dtype=state.x.dtype,
                            device=state.x.device)
            h_eff = state.h_global + l_mean * eye
        x_new = state.x - solve_newton_system(h_eff, grad)
        return FedNLState(x_new, h_local, h_global, state.step + 1,
                          state.draws)

    def bits_per_round(self, d: int) -> int:
        """Analytic uplink bits per device per round: gradient + S_i +
        l_i, in the paper's FLOAT_BITS."""
        from ..wire.report import analytic_bits

        return d * FLOAT_BITS + analytic_bits(self.comp, (d, d)) + FLOAT_BITS

    def init_bits(self, d: int) -> int:
        """The one-time cost of shipping H_i^0 (a symmetric matrix)."""
        return d * (d + 1) // 2 * FLOAT_BITS


@register("fednl")
def _make_fednl(oracles: Oracles, compressor, **params):
    return FedNL(oracles.grad, oracles.hess, compressor, **params)
