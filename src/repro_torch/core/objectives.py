"""Logistic-regression oracles of eq. (10), on stacked silo tensors.

    min_x (1/n) sum_i f_i(x) + (lambda/2) ||x||^2,
    f_i(x) = (1/m) sum_j log(1 + exp(-b_ij a_ij^T x))

Counterpart of ``repro.core.objectives``: per-silo oracles take one
(m, d) / (m,) slab; the ``batch_*`` oracles write the silo axis out as
the leading dimension of (n, m, d) / (n, m) tensors instead of vmapping
the per-silo ones. The regularizer is split evenly into every f_i.
Also: the quadratic oracles (for NS / N0 tests) and the GLM weights
phi'' that the NL1 baseline learns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LogRegData(NamedTuple):
    a: torch.Tensor  # (n, m, d) features
    b: torch.Tensor  # (n, m)    labels in {-1, +1}
    lam: float       # l2 regularization


def _log1pexp(t: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(t)) without overflow."""
    return torch.logaddexp(torch.zeros_like(t), t)


# -- per-silo oracles ---------------------------------------------------------


def silo_value(x, a, b, lam: float) -> torch.Tensor:
    margins = -b * (a @ x)
    return torch.mean(_log1pexp(margins)) + 0.5 * lam * torch.dot(x, x)


def silo_grad(x, a, b, lam: float) -> torch.Tensor:
    margins = -b * (a @ x)
    coef = torch.sigmoid(margins) * (-b)
    return a.T @ coef / a.shape[0] + lam * x


def silo_phi2(x, a, b) -> torch.Tensor:
    """phi''_ij(a_ij^T x), the GLM weights NL1 learns (eq. (2)); on
    stacked (n, m, d) / (n, m) data it gives (n, m)."""
    s = torch.sigmoid(-b * (a @ x))
    return s * (1.0 - s)


def silo_hess(x, a, b, lam: float) -> torch.Tensor:
    margins = -b * (a @ x)
    s = torch.sigmoid(margins)
    w = s * (1.0 - s)                          # phi'' weights; b^2 = 1
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return (a.T * w) @ a / a.shape[0] + lam * eye


# -- stacked (all-silo) oracles ----------------------------------------------


def batch_value(x, data: LogRegData) -> torch.Tensor:
    margins = -data.b * (data.a @ x)                       # (n, m)
    return torch.mean(_log1pexp(margins), dim=1) + 0.5 * data.lam * torch.dot(x, x)


def batch_grad(x, data: LogRegData) -> torch.Tensor:
    margins = -data.b * (data.a @ x)
    coef = torch.sigmoid(margins) * (-data.b)              # (n, m)
    at = data.a.transpose(1, 2)                            # (n, d, m)
    g = (at @ coef.unsqueeze(-1)).squeeze(-1)
    return g / data.a.shape[1] + data.lam * x


def batch_hess(x, data: LogRegData) -> torch.Tensor:
    margins = -data.b * (data.a @ x)
    s = torch.sigmoid(margins)
    w = s * (1.0 - s)                                      # (n, m)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    at = data.a.transpose(1, 2)                            # (n, d, m)
    return (at * w.unsqueeze(1)) @ data.a / data.a.shape[1] + data.lam * eye


def global_value(x, data: LogRegData) -> torch.Tensor:
    return torch.mean(batch_value(x, data))


def global_grad(x, data: LogRegData) -> torch.Tensor:
    return torch.mean(batch_grad(x, data), dim=0)


def global_hess(x, data: LogRegData) -> torch.Tensor:
    return torch.mean(batch_hess(x, data), dim=0)


# -- constants of Assumption 3.1 ----------------------------------------------


def lipschitz_constants(data: LogRegData) -> dict:
    """Upper bounds on (mu, L, L_*, L_F, L_inf) for eq. (10), the same
    crude bounds as the reference: |phi'''| <= 1/(6 sqrt 3)."""
    a = data.a
    norms = torch.linalg.vector_norm(a, dim=-1)            # (n, m)
    c3 = 0.09623
    l_star = float(torch.max(torch.mean(norms**3, dim=1)) * c3)
    amax = torch.amax(torch.abs(a), dim=-1)
    l_inf = float(torch.max(torch.mean(norms * amax**2, dim=1)) * c3)
    smooth = float(torch.max(torch.mean(norms**2, dim=1)) / 4.0 + data.lam)
    return dict(mu=data.lam, L=smooth, L_star=l_star, L_F=l_star,
                L_inf=l_inf)


# -- quadratic oracles (for NS / N0 / unit tests) ------------------------------


class QuadData(NamedTuple):
    q: torch.Tensor  # (n, d, d) per-silo PSD matrices
    c: torch.Tensor  # (n, d)    per-silo linear terms


def quad_value(x, data: QuadData) -> torch.Tensor:
    vals = (0.5 * x) @ data.q @ x - data.c @ x              # (n,)
    return torch.mean(vals)


def quad_grad(x, data: QuadData) -> torch.Tensor:
    return torch.mean(data.q @ x - data.c, dim=0)


def quad_hess_batch(x, data: QuadData) -> torch.Tensor:
    return data.q
