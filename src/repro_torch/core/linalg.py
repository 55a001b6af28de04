"""Linear algebra for FedNL's Newton step and FedNL-CR's cubic model
(counterpart of ``repro.core.linalg``).

Every function takes a matrix or a stack of matrices in its last two
dimensions.
"""

from __future__ import annotations

import torch


def symmetrize(m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (m + m.transpose(-2, -1))


def project_psd(m: torch.Tensor, mu: float = 0.0) -> torch.Tensor:
    """[X]_mu := [X - mu I]_0 + mu I with [Y]_0 clipping eigenvalues at 0
    (paper A.4, eqs. (19)-(20))."""
    sym = symmetrize(m)
    eye = torch.eye(sym.shape[-1], dtype=sym.dtype, device=sym.device)
    evals, evecs = torch.linalg.eigh(sym - mu * eye)
    clipped = torch.clamp(evals, min=0.0)
    return (evecs * clipped.unsqueeze(-2)) @ evecs.transpose(-2, -1) + mu * eye


def solve_newton_system(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g (LU with partial pivoting, as ``jnp.linalg.solve``)."""
    return torch.linalg.solve(h, g)


def frob_norm(m: torch.Tensor) -> torch.Tensor:
    """Frobenius norm over the last two dimensions."""
    return torch.sqrt(torch.sum(m * m, dim=(-2, -1)))


def solve_cubic_subproblem(g: torch.Tensor, h_mat: torch.Tensor,
                           m_cubic: float, iters: int = 100) -> torch.Tensor:
    """argmin_h <g, h> + 1/2 h^T H h + (M/6) ||h||^3 (paper E.2).

    Stationarity gives (H + (M/2) r I) h = -g with r = ||h||; in H's
    eigenbasis, with b = Q^T g, r solves
    phi(r) = sum_i b_i^2 / (lam_i + (M/2) r)^2 - r^2 = 0, which ``iters``
    bisection steps find on [max(0, -2 lam_min / M) + 1e-12, r_hi]. The
    loop stays on the tensors' device (no host sync). g = 0 returns 0."""
    lam, q = torch.linalg.eigh(symmetrize(h_mat))
    b = q.T @ g
    m_half = m_cubic / 2.0
    lam_min = lam[0]
    lo = torch.clamp(-2.0 * lam_min / m_cubic, min=0.0) + 1e-12
    gnorm = torch.sqrt(torch.sum(g * g))
    hi = (torch.abs(lam_min) + torch.sqrt(lam_min**2 + 2.0 * m_cubic * gnorm)
          ) / m_cubic + 1.0

    def denom(r):
        den = lam + m_half * r
        return torch.where(torch.abs(den) < 1e-30, 1e-30, den)

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = torch.sum((b / denom(mid)) ** 2) - mid**2 > 0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    h = -(q @ (b / denom(0.5 * (lo + hi))))
    return torch.where(gnorm > 1e-30, h, 0.0)
