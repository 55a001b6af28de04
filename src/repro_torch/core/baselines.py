"""First-order and Newton-type baselines the paper compares against,
counterpart of ``repro.core.baselines``.

GD, GD-LS   gradient descent (1/L step) and with backtracking
DIANA       compressed gradient differences [Mishchenko et al. 2019]
ADIANA      accelerated DIANA [Li et al. 2020b]
DINGO       distributed Newton-type method on the gradient norm
            [Crane & Roosta 2019]
NL1         Newton Learn for GLMs [Islamov et al. 2021]: learns
            per-point phi'' with Rand-K and reveals the touched points
DORE        double-residual bidirectional compression [Liu et al. 2020]
Artemis     bidirectional compression + partial participation
            [Philippenko & Dieuleveut 2021]

The randomized ones take their draws from a round-draw source
(``engine.method.RoundDraws`` from ``seed`` by default). Their server
means of compressed gradient differences are taken in payload space
(``Compressor.aggregate``: a Top-K or Rand-K vector payload is summed by
``scatter_accumulate`` into a (1, d) output); each silo keeps its own
decoded difference for its shift.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..engine.method import MethodBase, round_draws
from .compressors import FLOAT_BITS, INDEX_BITS, Compressor, RandK
from .newton import backtracking
from .objectives import batch_grad, silo_phi2


def _compressed_diffs(comp: Compressor, v: torch.Tensor, draws):
    """Each silo's payload of its (n, d) rows and the decoded rows it
    keeps for its shift."""
    payloads = comp.apply(v, draws.silos(comp, v.shape[0], v.shape[1:],
                                         v.dtype))
    return payloads, comp.decompress(payloads, v.shape[1:])


# ---------------------------------------------------------------------------
# Gradient descent
# ---------------------------------------------------------------------------


def gd_run(x0, grad_fn, lr: float, num_rounds: int):
    xs = [x0]
    for _ in range(num_rounds):
        xs.append(xs[-1] - lr * torch.mean(grad_fn(xs[-1]), dim=0))
    return xs[-1], torch.stack(xs)


def gd_ls_run(x0, value_fn, grad_fn, num_rounds: int, c: float = 0.5,
              gamma: float = 0.5, t0: float = 1.0):
    xs = [x0]
    for _ in range(num_rounds):
        x = xs[-1]
        g = torch.mean(grad_fn(x), dim=0)
        t = backtracking(value_fn, x, -g, g, c=c, gamma=gamma) * t0
        xs.append(torch.add(x, -g, alpha=t))
    return xs[-1], torch.stack(xs)


def gd_bits_per_round(d: int) -> int:
    return d * FLOAT_BITS


# ---------------------------------------------------------------------------
# DIANA
# ---------------------------------------------------------------------------


class DianaState(NamedTuple):
    x: torch.Tensor
    h_i: torch.Tensor  # (n, d) gradient shifts
    draws: Any


class Diana(MethodBase):
    """x^{k+1} = x^k - gamma (h + mean_i C(grad_i - h_i)); h_i += alpha
    C(grad_i - h_i). alpha = 1/(1 + omega), gamma = 1/(L (1 + 6 omega/n))."""

    def __init__(self, grad_fn, comp: Compressor, smooth_l: float, n: int,
                 omega: float):
        self.grad_fn = grad_fn
        self.comp = comp
        self.alpha = 1.0 / (1.0 + omega)
        self.gamma = 1.0 / (smooth_l * (1.0 + 6.0 * omega / n))

    def init(self, x0, n, seed: int = 0, draws=None) -> DianaState:
        return DianaState(x0, torch.zeros((n, x0.shape[0]), dtype=x0.dtype,
                                          device=x0.device),
                          round_draws(draws, seed, x0))

    def step(self, state: DianaState) -> DianaState:
        grads = self.grad_fn(state.x)
        pay, delta = _compressed_diffs(self.comp, grads - state.h_i,
                                       state.draws)
        g_hat = (torch.mean(state.h_i, dim=0)
                 + self.comp.aggregate(pay, delta.shape[1:]))
        return DianaState(x=state.x - self.gamma * g_hat,
                          h_i=state.h_i + self.alpha * delta,
                          draws=state.draws)

    def bits_per_round(self, d: int) -> int:
        from ..wire.report import analytic_bits

        return analytic_bits(self.comp, (d,))


# ---------------------------------------------------------------------------
# ADIANA
# ---------------------------------------------------------------------------


class AdianaState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor
    h_i: torch.Tensor
    draws: Any


class Adiana(MethodBase):
    """Accelerated DIANA (Li et al. 2020b, Alg. 2, strongly convex).

    Per round: x = th1 z + th2 w + (1 - th1 - th2) y;
    g = h + mean C(grad_i(x) - h_i); y+ = x - eta g;
    z+ = (z + gamma mu x - gamma g) / (1 + gamma mu);
    h_i += alpha C(grad_i(w) - h_i); w+ = y with probability p.
    alpha = 1/(1 + om), p = alpha,
    eta = min(1/(2 L (1 + 2 om/n)), n/(64 om L)), th2 = 1/2,
    th1 = min(1/4, sqrt(eta mu / p)), gamma = eta / (2 (th1 + eta mu)).
    """

    traj_field = "y"

    def __init__(self, grad_fn, comp: Compressor, smooth_l: float, mu: float,
                 n: int, omega: float):
        self.grad_fn = grad_fn
        self.comp = comp
        om = max(omega, 1e-12)
        self.alpha = 1.0 / (1.0 + om)
        self.p = self.alpha
        self.eta = min(1.0 / (2.0 * smooth_l * (1.0 + 2.0 * om / n)),
                       n / (64.0 * om * smooth_l) if omega > 0 else math.inf)
        self.th2 = 0.5
        self.th1 = min(0.25, math.sqrt(self.eta * mu / self.p))
        self.gamma = self.eta / (2.0 * (self.th1 + self.eta * mu))
        self.mu = mu

    def init(self, x0, n, seed: int = 0, draws=None) -> AdianaState:
        h0 = torch.zeros((n, x0.shape[0]), dtype=x0.dtype, device=x0.device)
        return AdianaState(x0, x0, x0, x0, h0, round_draws(draws, seed, x0))

    def step(self, state: AdianaState) -> AdianaState:
        x = (self.th1 * state.z + self.th2 * state.w
             + (1.0 - self.th1 - self.th2) * state.y)
        pay, _ = _compressed_diffs(self.comp, self.grad_fn(x) - state.h_i,
                                   state.draws)
        g = torch.mean(state.h_i, dim=0) + self.comp.aggregate(
            pay, x.shape)

        y_new = x - self.eta * g
        z_new = ((state.z + self.gamma * self.mu * x - self.gamma * g)
                 / (1.0 + self.gamma * self.mu))

        _, delta_w = _compressed_diffs(
            self.comp, self.grad_fn(state.w) - state.h_i, state.draws)
        h_new = state.h_i + self.alpha * delta_w
        w_new = state.y if state.draws.coin(self.p) else state.w
        return AdianaState(x, y_new, z_new, w_new, h_new, state.draws)

    def bits_per_round(self, d: int) -> int:
        from ..wire.report import analytic_bits

        return 2 * analytic_bits(self.comp, (d,))  # two compressed vectors


# ---------------------------------------------------------------------------
# DINGO
# ---------------------------------------------------------------------------


class Dingo:
    """DINGO (Crane & Roosta 2019) with theta = 1e-4, phi = 1e-6,
    rho = 1e-4, backtracking over {1, 2^-1, ..., 2^-10} on ||grad||^2
    (all 11 probes evaluated, the largest accepted taken).

    Case 1: p = -mean_i H_i^{-1} g        if <p, H g> <= -theta ||g||^2
    Cases 2/3: per silo, -H_i^{-1} g where it passes the same test, else
    the phi-regularized direction with its Lagrangian correction."""

    def __init__(self, value_fn, grad_fn, hess_fn, theta=1e-4, phi=1e-6,
                 rho=1e-4):
        self.value_fn = value_fn
        self.grad_fn = grad_fn
        self.hess_fn = hess_fn
        self.theta = theta
        self.phi = phi
        self.rho = rho

    def direction(self, x):
        hesses = self.hess_fn(x)                              # (n, d, d)
        g = torch.mean(self.grad_fn(x), dim=0)
        n, d = hesses.shape[:2]
        eye = torch.eye(d, dtype=x.dtype, device=x.device)

        hg = torch.mean(hesses, dim=0) @ g                     # \bar H g
        thresh = self.theta * torch.dot(g, g)
        p_pinv = -torch.linalg.solve(hesses, g.expand(n, d))   # (n, d)
        # the phi-regularized least squares: -(H^2 + phi^2 I)^{-1} H g
        reg = hesses @ hesses + self.phi**2 * eye
        p_reg = -torch.linalg.solve(reg, hesses @ g)
        p1 = torch.mean(p_pinv, dim=0)
        case1 = torch.dot(p1, hg) <= -thresh

        local_ok = p_pinv @ hg <= -thresh
        ht_hg = torch.linalg.solve(reg, hg.expand(n, d))
        num = p_reg @ hg + thresh
        den = torch.clamp(ht_hg @ hg, min=1e-30)
        lam = torch.clamp(num / den, min=0.0)
        p_fixed = p_reg - lam[:, None] * ht_hg
        p23 = torch.mean(torch.where(local_ok[:, None], p_pinv, p_fixed),
                         dim=0)
        return torch.where(case1, p1, p23), g

    def step(self, x):
        p, g = self.direction(x)
        hg = torch.mean(self.hess_fn(x), dim=0) @ g
        slope = 2.0 * self.rho * torch.dot(p, hg)
        gnorm2 = torch.dot(g, g)
        alphas = 2.0 ** -torch.arange(11.0, dtype=x.dtype, device=x.device)
        ok = []
        for a in alphas:
            gn = torch.mean(self.grad_fn(x + a * p), dim=0)
            ok.append(torch.dot(gn, gn) <= gnorm2 + a * slope)
        ok = torch.stack(ok)
        # the first acceptable (largest) step, else the smallest
        a = torch.where(torch.any(ok), alphas[torch.argmax(ok.to(torch.uint8))],
                        alphas[-1])
        return x + a * p

    @staticmethod
    def bits_per_round(d: int) -> int:
        """Both directions: DINGO moves several d-vectors per round."""
        return 6 * d * FLOAT_BITS

    def run(self, x0, num_rounds: int):
        xs = [x0]
        for _ in range(num_rounds):
            xs.append(self.step(xs[-1]))
        return xs[-1], torch.stack(xs)


# ---------------------------------------------------------------------------
# NL1 (Newton Learn, GLM-only predecessor)
# ---------------------------------------------------------------------------


class NL1State(NamedTuple):
    x: torch.Tensor
    gamma: torch.Tensor  # (n, m) learned phi'' coefficients
    draws: Any


class NL1:
    """NL1 of Islamov et al. 2021 for eq. (2) GLMs: learns
    gamma_ij -> phi''_ij(a_ij^T x*) by Rand-K over each silo's m points
    (the draw: K of m data points per silo); the server forms
    H = (1/nm) sum_ij gamma_ij a_ij a_ij^T + lam I, which needs the
    touched points, and takes the Newton step. eta = K/m = 1/(omega+1)."""

    def __init__(self, data, k: int = 1):
        self.data = data
        self.k = k
        self.eta = k / data.a.shape[1]

    def init(self, x0, seed: int = 0, draws=None) -> NL1State:
        return NL1State(x0, silo_phi2(x0, self.data.a, self.data.b),
                        round_draws(draws, seed, x0))

    def step(self, state: NL1State) -> NL1State:
        a = self.data.a
        n, m, d = a.shape
        idx = state.draws.silos(RandK(self.k), n, (m,), state.x.dtype)
        delta = silo_phi2(state.x, a, self.data.b) - state.gamma   # (n, m)
        mask = torch.zeros_like(delta).scatter_(1, idx.to(torch.int64), 1.0)
        gamma_new = torch.clamp(
            state.gamma + self.eta * (delta * mask * (m / self.k)), 0.0, 0.25)

        # the server's Hessian from the learned coefficients (+ ridge)
        silo_h = (a.transpose(1, 2) * gamma_new[:, None, :]) @ a / m
        eye = torch.eye(d, dtype=state.x.dtype, device=state.x.device)
        h = torch.mean(silo_h, dim=0) + self.data.lam * eye
        g = torch.mean(batch_grad(state.x, self.data), dim=0)
        return NL1State(state.x - torch.linalg.solve(h, g), gamma_new,
                        state.draws)

    def bits_per_round(self, d: int) -> int:
        # gradient + K coefficients + K data points of dimension d
        return (d * FLOAT_BITS + self.k * (FLOAT_BITS + INDEX_BITS)
                + self.k * d * FLOAT_BITS)

    def run(self, x0, num_rounds: int, seed: int = 0, draws=None):
        state, xs = self.init(x0, seed, draws), [x0]
        for _ in range(num_rounds):
            state = self.step(state)
            xs.append(state.x)
        return state, torch.stack(xs)


# ---------------------------------------------------------------------------
# DORE (bidirectional residual compression)
# ---------------------------------------------------------------------------


class DoreState(NamedTuple):
    x_hat: torch.Tensor  # (d,) model replica tracked by everyone
    x: torch.Tensor      # (d,) server model
    h_i: torch.Tensor    # (n, d) gradient shifts
    draws: Any


class Dore(MethodBase):
    """DORE [Liu et al. 2020]: DIANA's uplink (compressed gradient
    residuals with shifts) and a compressed downlink model residual that
    the replicas track with eta_m = 1/(1 + omega_down)."""

    def __init__(self, grad_fn, comp_up: Compressor, comp_down: Compressor,
                 smooth_l: float, n: int, omega_up: float, omega_down: float):
        self.grad_fn = grad_fn
        self.comp_up = comp_up
        self.comp_down = comp_down
        self.alpha = 1.0 / (1.0 + omega_up)
        self.gamma = 1.0 / (smooth_l * (1.0 + 6.0 * omega_up / n))
        self.eta_m = 1.0 / (1.0 + omega_down)

    def init(self, x0, n, seed: int = 0, draws=None) -> DoreState:
        h0 = torch.zeros((n, x0.shape[0]), dtype=x0.dtype, device=x0.device)
        return DoreState(x0, x0, h0, round_draws(draws, seed, x0))

    def step(self, state: DoreState) -> DoreState:
        grads = self.grad_fn(state.x_hat)          # at the replica
        pay, delta = _compressed_diffs(self.comp_up, grads - state.h_i,
                                       state.draws)
        g_hat = (torch.mean(state.h_i, dim=0)
                 + self.comp_up.aggregate(pay, delta.shape[1:]))
        x_new = state.x - self.gamma * g_hat
        _, q = _compressed_diffs(self.comp_down, (x_new - state.x_hat)[None],
                                 state.draws)
        return DoreState(state.x_hat + self.eta_m * q[0], x_new,
                         state.h_i + self.alpha * delta, state.draws)

    def bits_per_round(self, d: int) -> tuple[int, int]:
        from ..wire.report import analytic_bits

        return analytic_bits(self.comp_up, (d,)), analytic_bits(self.comp_down, (d,))


# ---------------------------------------------------------------------------
# Artemis (bidirectional compression + partial participation)
# ---------------------------------------------------------------------------


class ArtemisState(NamedTuple):
    x: torch.Tensor
    h_i: torch.Tensor
    draws: Any


class Artemis(MethodBase):
    """Artemis [Philippenko & Dieuleveut 2021] as the paper benchmarks
    it: compressed gradient differences with memory on the uplink, an
    uncompressed downlink direction, tau active silos a round."""

    def __init__(self, grad_fn, comp_up: Compressor, smooth_l: float, n: int,
                 omega: float, tau: int):
        self.grad_fn = grad_fn
        self.comp = comp_up
        self.tau = tau
        self.n = n
        self.alpha = 1.0 / (1.0 + omega)
        self.gamma = 1.0 / (smooth_l * (1.0 + 6.0 * omega * n / (tau * n)))

    def init(self, x0, n, seed: int = 0, draws=None) -> ArtemisState:
        h0 = torch.zeros((n, x0.shape[0]), dtype=x0.dtype, device=x0.device)
        return ArtemisState(x0, h0, round_draws(draws, seed, x0))

    def step(self, state: ArtemisState) -> ArtemisState:
        n = state.h_i.shape[0]
        active = state.draws.active(n, self.tau)
        pay, delta = _compressed_diffs(
            self.comp, self.grad_fn(state.x) - state.h_i, state.draws)
        # the sum over the active silos / tau, as a weighted server mean
        g_hat = torch.mean(state.h_i, dim=0) + self.comp.aggregate(
            pay, delta.shape[1:], weights=active.to(delta.dtype)) * (
                n / self.tau)
        h_new = state.h_i + self.alpha * torch.where(active[:, None], delta,
                                                     0.0)
        return ArtemisState(state.x - self.gamma * g_hat, h_new, state.draws)

    def bits_per_round(self, d: int) -> int:
        from ..wire.report import analytic_bits

        return analytic_bits(self.comp, (d,))  # per active device
