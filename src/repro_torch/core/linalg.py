"""Linear algebra for FedNL's Newton step (counterpart of
``repro.core.linalg``, without the cubic solver FedNL-CR needs).

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
