"""Cross-device cohort layer on top of FedNL-PP, counterpart of
``repro.core.cohort``.

FedNL-PP (Algorithm 2) samples tau of n silos a round and weights the
others 0. A cross-device deployment changes three things, all in ONE
spec (``CohortSpec``):

  * the registered *population* N is large, and every round samples a
    *cohort* of K participants from it;
  * participants arrive asynchronously — the traffic model's per-silo
    upload times (``wire.traffic``, the fl-cross-device preset by
    default) decide who makes the round's deadline, set at a quantile
    of the cohort's arrival distribution;
  * stragglers are not dropped: their contributions land with a
    staleness-decayed weight (1 + s)^(-beta) through the ``weights=`` of
    ``Compressor.aggregate``, the same payload-space weighting as the
    0/1 participation mask, so the weights stay on the device.

The cohort is drawn from the method's round-draw source
(``RoundDraws.active``), as FedNL-PP's is; arrival times are host numpy
from ``CohortSpec.seed`` and the payload's analytic bits, equal to the
reference's, computed once per (n, bits).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..engine.method import Oracles, register
from ..wire.traffic import link_model
from .compressors import Compressor
from .fednl_pp import FedNLPP, FedNLPPState, corrected_grads
from .linalg import frob_norm, solve_newton_system


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """Cross-device participation model, consumed by ``ExperimentSpec``,
    ``Sweep`` and the method.

    population:        registered clients N; None adopts the problem's
                       silo count at init (a set value must match it)
    cohort:            participants K sampled uniformly per round
    staleness_beta:    straggler discount exponent — a contribution s
                       rounds stale is weighted (1 + s)^(-beta); 0 keeps
                       FedNL-PP's pure 0/1 mask
    link:              traffic-model preset (or LinkModel) whose per-silo
                       upload-time draws decide who makes the deadline
    deadline_quantile: the round closes at this quantile of the cohort's
                       arrival times (1.0 = wait for every straggler)
    seed:              seeds the host-side arrival draws (numpy)
    """

    cohort: int
    population: Optional[int] = None
    staleness_beta: float = 0.5
    link: object = "fl-cross-device"
    deadline_quantile: float = 0.8
    seed: int = 0

    def __post_init__(self):
        if self.cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {self.cohort}")
        if self.population is not None and self.population < self.cohort:
            raise ValueError(
                f"population ({self.population}) smaller than cohort "
                f"({self.cohort})")
        if not 0.0 < self.deadline_quantile <= 1.0:
            raise ValueError("deadline_quantile must be in (0, 1], got "
                             f"{self.deadline_quantile}")
        if self.staleness_beta < 0.0:
            raise ValueError("staleness_beta must be >= 0, got "
                             f"{self.staleness_beta}")


def sample_cohort(draws, population: int, cohort: int) -> torch.Tensor:
    """(population,) bool mask of a uniform K-of-N cohort from a round-
    draw source: exactly ``min(cohort, population)`` True entries."""
    return draws.active(int(population), min(int(cohort), int(population)))


def arrival_times(spec: CohortSpec, n: int,
                  bits_per_silo: float) -> np.ndarray:
    """(n,) host-side per-silo upload seconds for one round, drawn from
    the spec's link model — deterministic in ``spec.seed``."""
    link = link_model(spec.link)
    return link.silo_seconds(float(bits_per_silo), int(n), seed=spec.seed)


def on_time_mask(times: np.ndarray, deadline_quantile: float) -> np.ndarray:
    """(n,) bool: who beats the round deadline, set at the configured
    quantile of the cohort's arrival distribution."""
    deadline = np.quantile(times, float(deadline_quantile))
    return times <= deadline


def staleness_weights(staleness: torch.Tensor, beta: float,
                      dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(1 + s)^(-beta) straggler discount in ``dtype`` (the reference's
    ambient f64); beta = 0 gives weight 1, and a negative staleness
    counts as fresh."""
    s = torch.clamp(staleness, min=0).to(dtype)
    return (1.0 + s) ** (-float(beta))


class CohortFedNLPPState(NamedTuple):
    w: torch.Tensor           # (n, d) stale local models
    h_local: torch.Tensor     # (n, d, d)
    l_local: torch.Tensor     # (n,)
    g_local: torch.Tensor     # (n, d)
    h_global: torch.Tensor    # (d, d)
    l_global: torch.Tensor    # ()
    g_global: torch.Tensor    # (d,)
    x: torch.Tensor           # (d,)
    step: int
    draws: object             # round-draw source
    last_round: torch.Tensor  # (n,) int32 — the round each silo last landed


class CohortFedNLPP(FedNLPP):
    """FedNL-PP with the cohort layer: K-of-N sampling, deadline-based
    arrival, staleness-weighted straggler contributions.

    Server update: H^{k+1} = H^k + alpha mean_i w_i S_i with
    w_i = active_i * (1 if on time else (1 + staleness_i)^(-beta)); each
    local H_i takes the SAME weighted increment, so the server aggregate
    stays the exact mean of the local updates. beta = 0 and
    deadline_quantile = 1 recover FedNL-PP with tau = cohort bit for
    bit."""

    def __init__(self, grad_fn_at: Callable, hess_fn_at: Callable,
                 compressor: Compressor, cohort: CohortSpec,
                 alpha: float = 1.0):
        super().__init__(grad_fn_at, hess_fn_at, compressor,
                         tau=cohort.cohort, alpha=alpha)
        self.cohort = cohort
        self._on_time = {}        # (n, bits, device) -> (n,) bool

    def init(self, x0: torch.Tensor, n: int, seed: int = 0,
             draws=None) -> CohortFedNLPPState:
        if (self.cohort.population is not None
                and int(self.cohort.population) != int(n)):
            raise ValueError(
                f"CohortSpec.population={self.cohort.population} but the "
                f"problem has n={n} silos")
        base = super().init(x0, n, seed=seed, draws=draws)
        return CohortFedNLPPState(
            *base, last_round=torch.zeros(n, dtype=torch.int32,
                                          device=x0.device))

    def round_weights(self, state: CohortFedNLPPState,
                      active: torch.Tensor) -> torch.Tensor:
        """(n,) per-silo aggregation weights on the device: 0 for the
        unsampled, 1 for on-time arrivals, the staleness discount for
        stragglers. Who is on time comes from the arrival times of the
        payload's analytic bits, computed once per (n, bits)."""
        from ..wire.report import analytic_bits

        n, d = state.w.shape
        key = (n, analytic_bits(self.comp, (d, d)), state.x.device)
        if key not in self._on_time:
            self._on_time[key] = torch.from_numpy(on_time_mask(
                arrival_times(self.cohort, n, key[1]),
                self.cohort.deadline_quantile)).to(state.x.device)
        decay = staleness_weights(state.step - state.last_round,
                                  self.cohort.staleness_beta)
        late_w = decay.to(state.x.dtype)
        w = torch.where(self._on_time[key], torch.ones_like(late_w), late_w)
        return torch.where(active, w, torch.zeros_like(w))

    def step(self, state: CohortFedNLPPState) -> CohortFedNLPPState:
        n, d = state.w.shape
        eye = torch.eye(d, dtype=state.x.dtype, device=state.x.device)
        x_new = solve_newton_system(state.h_global + state.l_global * eye,
                                    state.g_global)
        active = sample_cohort(state.draws, n, self.tau)
        wts = self.round_weights(state, active)
        silo_draws = state.draws.silos(self.comp, n, (d, d), state.x.dtype)

        hess_new = self.hess_fn(x_new)
        grads_new = self.grad_fn(x_new)
        payloads, _ = self._uplink_diff_payloads(hess_new, state.h_local,
                                                 silo_draws)
        s_i = self._local_hessians(payloads, (d, d))
        # the weighted increment, applied alike on the silos and (as the
        # payload-space weighted mean) on the server
        h_upd = state.h_local + (self.alpha * wts)[:, None, None] * s_i
        l_upd = frob_norm(h_upd - hess_new)
        g_upd = corrected_grads(h_upd, l_upd, x_new, grads_new)

        mask, maskm = active[:, None], active[:, None, None]
        h_global = state.h_global + self.alpha * self._server_aggregate(
            payloads, (d, d), weights=wts)
        l_global = state.l_global + torch.mean(
            torch.where(active, l_upd - state.l_local, 0.0))
        g_global = state.g_global + torch.mean(
            torch.where(mask, g_upd - state.g_local, 0.0), dim=0)
        base = FedNLPPState(
            w=torch.where(mask, x_new[None], state.w),
            h_local=torch.where(maskm, h_upd, state.h_local),
            l_local=torch.where(active, l_upd, state.l_local),
            g_local=torch.where(mask, g_upd, state.g_local),
            h_global=h_global, l_global=l_global, g_global=g_global,
            x=x_new, step=state.step + 1, draws=state.draws)
        return CohortFedNLPPState(
            *base, last_round=torch.where(
                active, torch.full_like(state.last_round, state.step + 1),
                state.last_round))


@register("fednl-cohort")
def _make_fednl_cohort(oracles: Oracles, compressor, **params):
    return CohortFedNLPP(oracles.grad, oracles.hess, compressor, **params)
