"""FedNL-PP — Algorithm 2 (partial participation), counterpart of
``repro.core.fednl_pp``.

Server state: g = mean_i g_i, H = mean_i H_i, l = mean_i l_i. Every
round:

  x^{k+1} = (H^k + l^k I)^{-1} g^k                      # line 4
  a uniform subset S^k of tau silos                      # line 5
  i in S^k:  w_i <- x^{k+1}
             H_i <- H_i + alpha C(hess_i(w_i) - H_i)
             l_i <- ||H_i - hess_i(w_i)||_F
             g_i <- (H_i + l_i I) w_i - grad_i(w_i)      # Hessian-corrected
  the others: frozen; the server updates g, H, l from the diffs.

Every silo computes its update and it is applied where the silo is
active; the server's Hessian sum weights the payloads by the 0/1 mask
and, like the l and g updates, divides by n.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..engine.method import MethodBase, Oracles, register, round_draws
from .compressors import FLOAT_BITS, Compressor
from .linalg import frob_norm, solve_newton_system


class FedNLPPState(NamedTuple):
    w: torch.Tensor         # (n, d) stale local models
    h_local: torch.Tensor   # (n, d, d)
    l_local: torch.Tensor   # (n,)
    g_local: torch.Tensor   # (n, d) Hessian-corrected local gradients
    h_global: torch.Tensor  # (d, d)
    l_global: torch.Tensor  # ()
    g_global: torch.Tensor  # (d,)
    x: torch.Tensor         # (d,) latest global model (for monitoring)
    step: int
    draws: Any              # round-draw source


def corrected_grads(h, l, x, grads):
    """g_i = (H_i + l_i I) x_i - grad_i per silo: h (n, d, d), l (n,),
    x (d,) or (n, d), grads (n, d)."""
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    xs = x.expand(grads.shape).unsqueeze(-1)
    return ((h + l[:, None, None] * eye) @ xs).squeeze(-1) - grads


class FedNLPP(MethodBase):
    def __init__(self, grad_fn_at: Callable, hess_fn_at: Callable,
                 compressor: Compressor, tau: int, alpha: float = 1.0):
        self.grad_fn = grad_fn_at
        self.hess_fn = hess_fn_at
        self.comp = compressor
        self.tau = tau
        self.alpha = alpha

    def init(self, x0: torch.Tensor, n: int, seed: int = 0,
             draws=None) -> FedNLPPState:
        w = x0[None].repeat(n, 1)
        h0 = self.hess_fn(x0)                       # H_i^0 = hess_i(x0)
        l0 = frob_norm(h0 - h0)                     # zeros
        g0 = corrected_grads(h0, l0, w, self.grad_fn(x0))
        return FedNLPPState(
            w=w, h_local=h0, l_local=l0, g_local=g0,
            h_global=torch.mean(h0, dim=0), l_global=torch.mean(l0),
            g_global=torch.mean(g0, dim=0), x=x0, step=0,
            draws=round_draws(draws, seed, x0))

    def step(self, state: FedNLPPState) -> FedNLPPState:
        n, d = state.w.shape
        eye = torch.eye(d, dtype=state.x.dtype, device=state.x.device)

        # line 4: the global model from the server's aggregates
        x_new = solve_newton_system(state.h_global + state.l_global * eye,
                                    state.g_global)
        # line 5: tau silos uniformly
        active = state.draws.active(n, self.tau)
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.x.dtype)

        hess_new = self.hess_fn(x_new)
        grads_new = self.grad_fn(x_new)
        payloads, _ = self._uplink_diff_payloads(hess_new, state.h_local,
                                                 silo_draws)
        s_i = self._local_hessians(payloads, (d, d))
        h_upd = state.h_local + self.alpha * s_i
        l_upd = frob_norm(h_upd - hess_new)
        g_upd = corrected_grads(h_upd, l_upd, x_new, grads_new)

        mask, maskm = active[:, None], active[:, None, None]
        # server lines 18-20: a zero weight removes an inactive silo's
        # payload from the sum
        h_global = state.h_global + self.alpha * self._server_aggregate(
            payloads, (d, d), weights=active.to(state.x.dtype))
        l_global = state.l_global + torch.mean(
            torch.where(active, l_upd - state.l_local, 0.0))
        g_global = state.g_global + torch.mean(
            torch.where(mask, g_upd - state.g_local, 0.0), dim=0)
        return FedNLPPState(
            w=torch.where(mask, x_new[None], state.w),
            h_local=torch.where(maskm, h_upd, state.h_local),
            l_local=torch.where(active, l_upd, state.l_local),
            g_local=torch.where(mask, g_upd, state.g_local),
            h_global=h_global, l_global=l_global, g_global=g_global,
            x=x_new, step=state.step + 1, draws=state.draws)

    def bits_per_round(self, d: int) -> int:
        """Per active device: S_i + the l diff + the g diff."""
        from ..wire.report import analytic_bits

        return analytic_bits(self.comp, (d, d)) + FLOAT_BITS + d * FLOAT_BITS


@register("fednl-pp")
def _make_fednl_pp(oracles: Oracles, compressor, **params):
    return FedNLPP(oracles.grad, oracles.hess, compressor, **params)
