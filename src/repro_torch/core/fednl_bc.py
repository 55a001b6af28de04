"""FedNL-BC — Algorithm 5 (bidirectional compression), counterpart of
``repro.core.fednl_bc``.

Uplink: with the flag xi^k the devices send their gradients at the
learned model z^k; without it the server uses the Hessian-corrected
g_i = H_i^k (z^k - w^k) + grad_i(w^k) from the last synced point w^k.
Hessian diffs are compressed every round as in FedNL.
Downlink: the server sends s^k = C_M(x^{k+1} - z^k) and everyone learns
z^{k+1} = z^k + eta s^k. xi^{k+1} ~ Bernoulli(p), drawn at the end of
the round.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..engine.method import (
    MethodBase,
    Oracles,
    payload_wire_bits,
    register,
    round_draws,
)
from .compressors import FLOAT_BITS, Compressor, canonical_float_bits
from .linalg import project_psd, solve_newton_system


class FedNLBCState(NamedTuple):
    z: torch.Tensor         # (d,) learned global model (devices + server)
    w: torch.Tensor         # (d,) last gradient-sync model
    grad_w: torch.Tensor    # (n, d) per-silo gradients at w
    h_local: torch.Tensor   # (n, d, d)
    h_global: torch.Tensor  # (d, d)
    xi: bool                # this round's Bernoulli flag
    x: torch.Tensor         # (d,) server's uncompressed iterate
    step: int
    draws: Any              # round-draw source


def downlink(comp_m: Compressor, v: torch.Tensor, draw) -> torch.Tensor:
    """What the devices decode from the server's compressed (d,) vector
    ``v`` (a stack of one)."""
    return comp_m.decompress(comp_m.apply(v[None], draw), v.shape)[0]


class FedNLBC(MethodBase):
    traj_field = "z"  # devices only ever hold the learned model z

    def __init__(self, grad_fn: Callable, hess_fn: Callable,
                 compressor: Compressor, model_compressor: Compressor,
                 p: float = 1.0, alpha: float = 1.0, eta: float = 1.0,
                 option: int = 1, mu: float = 0.0):
        if option not in (1, 2):
            raise ValueError(f"option must be 1 or 2, got {option}")
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn
        self.comp = compressor
        self.comp_m = model_compressor
        self.p = p
        self.alpha = alpha
        self.eta = eta
        self.option = option
        self.mu = mu

    def init(self, x0: torch.Tensor, n: int, seed: int = 0,
             draws=None) -> FedNLBCState:
        h0 = self.hess_fn(x0)
        return FedNLBCState(
            z=x0, w=x0, grad_w=self.grad_fn(x0), h_local=h0,
            h_global=torch.mean(h0, dim=0), xi=True, x=x0, step=0,
            draws=round_draws(draws, seed, x0))

    def step(self, state: FedNLBCState) -> FedNLBCState:
        n, d = state.grad_w.shape
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.z.dtype)

        # devices: gradients at z every round, used where xi
        grad_z = self.grad_fn(state.z)
        if state.xi:
            g_i, w_new, grad_w_new = grad_z, state.z, grad_z
        else:
            g_i = (state.h_local @ (state.z - state.w)) + state.grad_w
            w_new, grad_w_new = state.w, state.grad_w
        hess_z = self.hess_fn(state.z)
        payloads, l_i = self._uplink_diff_payloads(hess_z, state.h_local,
                                                   silo_draws)
        s_i = self._local_hessians(payloads, (d, d))

        # server
        g = torch.mean(g_i, dim=0)
        if self.option == 1:
            h_eff = project_psd(state.h_global, self.mu)
        else:
            eye = torch.eye(d, dtype=state.z.dtype, device=state.z.device)
            h_eff = state.h_global + torch.mean(l_i) * eye
        x_new = state.z - solve_newton_system(h_eff, g)
        h_local = state.h_local + self.alpha * s_i
        h_global = state.h_global + self.alpha * self._server_aggregate(
            payloads, (d, d))

        # downlink: the compressed model increment
        down_draw = state.draws.silos(self.comp_m, 1, (d,), state.z.dtype)
        z_new = state.z + self.eta * downlink(self.comp_m, x_new - state.z,
                                              down_draw)
        return FedNLBCState(z_new, w_new, grad_w_new, h_local, h_global,
                            state.draws.coin(self.p), x_new, state.step + 1,
                            state.draws)

    def bits_per_round(self, d: int) -> tuple[float, int]:
        """(expected uplink bits per device, downlink bits)."""
        from ..wire.report import analytic_bits

        up = (self.p * d * FLOAT_BITS + analytic_bits(self.comp, (d, d))
              + FLOAT_BITS)
        down = analytic_bits(self.comp_m, (d,)) + 1  # model increment + xi bit
        return up, down

    def measured_bits_per_round(self, d: int, index_coding: str = "raw",
                                dtype: torch.dtype = torch.float64
                                ) -> tuple[float, int]:
        """Measured (uplink, downlink): this wire is bidirectional, so
        both compressors' payload structures, and the floats in
        ``dtype``."""
        fb = canonical_float_bits(dtype)
        up = (self.p * d * fb
              + payload_wire_bits(self.comp, (d, d), index_coding, dtype)
              + fb)
        down = payload_wire_bits(self.comp_m, (d,), index_coding, dtype) + 1
        return up, down


@register("fednl-bc")
def _make_fednl_bc(oracles: Oracles, compressor, model_compressor, **params):
    return FedNLBC(oracles.grad, oracles.hess, compressor, model_compressor,
                   **params)
