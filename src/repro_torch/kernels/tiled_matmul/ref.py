"""Plain PyTorch versions of the f32 tiled matmul and of the PowerSGD
rank-R power iteration built on it: ``torch.matmul`` on f32 operands.
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
