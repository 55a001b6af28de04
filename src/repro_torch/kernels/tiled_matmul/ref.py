"""Plain PyTorch versions of the f32 tiled matmul and of the PowerSGD
rank-R power iteration built on it: ``torch.matmul`` on f32 operands and
``torch.linalg.qr``.
Set ``torch.backends.cuda.matmul.allow_tf32 = False`` (its default) for
a full-f32 product on a card."""

from __future__ import annotations

import torch


def tiled_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b computed in f32, returned in a's type."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def subspace_iteration_ref(m: torch.Tensor, q: torch.Tensor,
                        iters: int = 2) -> torch.Tensor:
    """Subspace iteration from the orthonormal start ``q`` (d1, r) with
    plain matmuls and QR; the rank-r approximation in m's type."""
    m32 = m.to(torch.float32)
    for _ in range(iters):
        p, _ = torch.linalg.qr(m32 @ q)
        q, _ = torch.linalg.qr(m32.T @ p)
    p = m32 @ q
    return (p @ q.T).to(m.dtype)


def powersgd_rank_r_ref(m: torch.Tensor, r: int, iters: int = 2,
                        q0: torch.Tensor | None = None,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """Rank-r approximation of m by subspace iteration from the Gaussian
    start ``q0`` (d1, r), orthonormalized by QR as the reference does;
    without ``q0`` it is drawn in f32 from ``generator``. Torch cannot
    redraw the reference's ``PRNGKey(seed)`` start, so one of the two
    must be given."""
    if q0 is None:
        if generator is None:
            raise ValueError("powersgd_rank_r_ref needs the start q0 or a "
                             "generator to draw it from")
        q0 = torch.randn((m.shape[1], r), generator=generator,
                         dtype=torch.float32, device=generator.device)
    q, _ = torch.linalg.qr(q0.to(device=m.device, dtype=torch.float32))
    return subspace_iteration_ref(m, q, iters)
