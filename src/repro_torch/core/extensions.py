"""Beyond-paper extensions for the paper's own stated limitations
(Appendix I), counterpart of ``repro.core.extensions``.

* ``StochasticFedNL``: FedNL (Option 2) with per-round subsampled local
  Hessians and exact gradients.
* ``FedNLPPBC``: partial participation (Algorithm 2) with the learned,
  compressed broadcast model of Algorithm 5: the active silos only see
  z^{k+1} = z^k + eta C_M(x^{k+1} - z^k).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..engine.method import (
    MethodBase,
    Oracles,
    payload_wire_bits,
    register,
    round_draws,
)
from .compressors import FLOAT_BITS, Compressor, RandK, canonical_float_bits
from .fednl import FedNLState
from .fednl_bc import downlink
from .fednl_pp import corrected_grads
from .linalg import frob_norm, solve_newton_system
from .objectives import LogRegData, batch_hess


class SubsampledHessian:
    """A stochastic Hessian oracle: each silo's Hessian on ``m_sub`` of
    its m points, a uniform subset each round. Its draw comes from the
    round-draw source, as a randomized compressor's does: ``draw(gen)``
    is the (n, m_sub) points, ``self(x, points)`` the (n, d, d)
    Hessians."""

    def __init__(self, data: LogRegData, m_sub: int):
        self.data = data
        self.m_sub = m_sub

    def draw(self, gen) -> torch.Tensor:
        n, m = self.data.a.shape[:2]
        return RandK(self.m_sub).draw(n, (m,), None, gen)

    def __call__(self, x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        idx = points.to(device=x.device, dtype=torch.int64)
        a = torch.gather(self.data.a, 1, idx[..., None].expand(
            -1, -1, self.data.a.shape[2]))
        return batch_hess(x, self.data._replace(
            a=a, b=torch.gather(self.data.b, 1, idx)))


class ExactHessian:
    """The exact local Hessians as a stochastic oracle: it draws
    nothing."""

    def __init__(self, hess_fn):
        self.hess_fn = hess_fn

    def draw(self, gen) -> None:
        return None

    def __call__(self, x: torch.Tensor, draw=None) -> torch.Tensor:
        return self.hess_fn(x)


class StochasticFedNL(MethodBase):
    """FedNL (Option 2) with stochastic local Hessians.

    ``hess_fn_stoch`` is an oracle like ``SubsampledHessian``:
    ``hess_fn_stoch(x, draw) -> (n, d, d)`` on the draw that the
    round-draw source's ``oracle(hess_fn_stoch)`` hands it; ``init``
    takes one such draw before the first round. ``alpha`` should be
    damped: the compressed difference chases a noisy target."""

    def __init__(self, grad_fn, hess_fn_stoch, compressor: Compressor,
                 alpha: float = 0.5):
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn_stoch
        self.comp = compressor
        self.alpha = alpha

    def init(self, x0, n, seed: int = 0, draws=None) -> FedNLState:
        draws = round_draws(draws, seed, x0)
        h0 = self.hess_fn(x0, draws.oracle(self.hess_fn))
        return FedNLState(x=x0, h_local=h0, h_global=torch.mean(h0, dim=0),
                          step=0, draws=draws)

    def step(self, state: FedNLState) -> FedNLState:
        n, d = state.h_local.shape[:2]
        grads = self.grad_fn(state.x)
        hesses = self.hess_fn(state.x, state.draws.oracle(self.hess_fn))
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.x.dtype)
        payloads, l_i = self._uplink_diff_payloads(hesses, state.h_local,
                                                   silo_draws)
        s_i = self._local_hessians(payloads, (d, d))

        eye = torch.eye(d, dtype=state.x.dtype, device=state.x.device)
        h_eff = state.h_global + torch.mean(l_i) * eye
        x_new = state.x - solve_newton_system(h_eff, torch.mean(grads, dim=0))
        return FedNLState(
            x=x_new,
            h_local=state.h_local + self.alpha * s_i,
            h_global=state.h_global + self.alpha * self._server_aggregate(
                payloads, (d, d)),
            step=state.step + 1, draws=state.draws)

    def bits_per_round(self, d: int) -> int:
        """Uplink per device: gradient + S_i + l_i (as FedNL Option 2)."""
        from ..wire.report import analytic_bits

        return d * FLOAT_BITS + analytic_bits(self.comp, (d, d)) + FLOAT_BITS


class FedNLPPBCState(NamedTuple):
    z: torch.Tensor         # (d,) learned broadcast model
    w: torch.Tensor         # (n, d) per-silo last-participation models
    h_local: torch.Tensor   # (n, d, d)
    l_local: torch.Tensor   # (n,)
    g_local: torch.Tensor   # (n, d) Hessian-corrected local gradients
    h_global: torch.Tensor
    l_global: torch.Tensor
    g_global: torch.Tensor
    x: torch.Tensor         # server's uncompressed iterate
    step: int
    draws: Any              # round-draw source


class FedNLPPBC(MethodBase):
    """FedNL-PP x FedNL-BC (beyond the paper). Per round the server
    steps x^{k+1} = (H + l I)^{-1} g, broadcasts s = C_M(x^{k+1} - z)
    (z <- z + eta s) and samples tau silos; the active silos learn
    H_i, l_i and g_i at z as in Algorithm 2, and the server aggregates
    their diffs."""

    traj_field = "z"

    def __init__(self, grad_fn, hess_fn, compressor: Compressor,
                 model_compressor: Compressor, tau: int,
                 alpha: float = 1.0, eta: float = 1.0):
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn
        self.comp = compressor
        self.comp_m = model_compressor
        self.tau = tau
        self.alpha = alpha
        self.eta = eta

    def init(self, x0, n, seed: int = 0, draws=None) -> FedNLPPBCState:
        h0 = self.hess_fn(x0)
        l0 = torch.zeros(n, dtype=x0.dtype, device=x0.device)
        g0 = corrected_grads(h0, l0, x0, self.grad_fn(x0))
        return FedNLPPBCState(
            z=x0, w=x0[None].repeat(n, 1), h_local=h0, l_local=l0,
            g_local=g0, h_global=torch.mean(h0, dim=0),
            l_global=torch.mean(l0), g_global=torch.mean(g0, dim=0), x=x0,
            step=0, draws=round_draws(draws, seed, x0))

    def step(self, state: FedNLPPBCState) -> FedNLPPBCState:
        n, d = state.w.shape
        eye = torch.eye(d, dtype=state.z.dtype, device=state.z.device)

        # server: the Newton-type step, then the compressed broadcast
        x_new = solve_newton_system(state.h_global + state.l_global * eye,
                                    state.g_global)
        down_draw = state.draws.silos(self.comp_m, 1, (d,), state.z.dtype)
        z_new = state.z + self.eta * downlink(self.comp_m, x_new - state.z,
                                              down_draw)
        active = state.draws.active(n, self.tau)

        # every silo's update at z_new, applied where active
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.z.dtype)
        hess_z = self.hess_fn(z_new)
        grads_z = self.grad_fn(z_new)
        payloads, _ = self._uplink_diff_payloads(hess_z, state.h_local,
                                                 silo_draws)
        s_i = self._local_hessians(payloads, (d, d))
        h_upd = state.h_local + self.alpha * s_i
        l_upd = frob_norm(h_upd - hess_z)
        g_upd = corrected_grads(h_upd, l_upd, z_new, grads_z)

        mask, maskm = active[:, None], active[:, None, None]
        return FedNLPPBCState(
            z=z_new,
            w=torch.where(mask, z_new[None], state.w),
            h_local=torch.where(maskm, h_upd, state.h_local),
            l_local=torch.where(active, l_upd, state.l_local),
            g_local=torch.where(mask, g_upd, state.g_local),
            h_global=state.h_global + self.alpha * self._server_aggregate(
                payloads, (d, d), weights=active.to(state.z.dtype)),
            l_global=state.l_global + torch.mean(
                torch.where(active, l_upd - state.l_local, 0.0)),
            g_global=state.g_global + torch.mean(
                torch.where(mask, g_upd - state.g_local, 0.0), dim=0),
            x=x_new, step=state.step + 1, draws=state.draws)

    def bits_per_round(self, d: int) -> tuple[int, int]:
        """(uplink per active silo, downlink broadcast)."""
        from ..wire.report import analytic_bits

        up = analytic_bits(self.comp, (d, d)) + FLOAT_BITS + d * FLOAT_BITS
        return up, analytic_bits(self.comp_m, (d,))

    def measured_bits_per_round(self, d: int, index_coding: str = "raw",
                                dtype: torch.dtype = torch.float64
                                ) -> tuple[int, int]:
        """Measured (uplink per active silo, downlink): a bidirectional
        wire."""
        fb = canonical_float_bits(dtype)
        up = (payload_wire_bits(self.comp, (d, d), index_coding, dtype)
              + fb + d * fb)
        return up, payload_wire_bits(self.comp_m, (d,), index_coding, dtype)


@register("fednl-stoch")
def _make_fednl_stoch(oracles: Oracles, compressor, hess_fn_stoch=None,
                      **params):
    if hess_fn_stoch is None:  # exact Hessians
        hess_fn_stoch = ExactHessian(oracles.hess)
    return StochasticFedNL(oracles.grad, hess_fn_stoch, compressor, **params)


@register("fednl-ppbc")
def _make_fednl_ppbc(oracles: Oracles, compressor, model_compressor,
                     **params):
    return FedNLPPBC(oracles.grad, oracles.hess, compressor,
                     model_compressor, **params)
