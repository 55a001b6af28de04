"""Plain PyTorch version of the fused FedNL Hessian bookkeeping, with the
kernel's arithmetic: H + alpha * S with one rounding (``torch.add`` with
``alpha`` is a fused multiply-add, as XLA's is), and ||H - D||_F from f32
squares of H - D summed per (block x block) tile, then over the tiles. This is what the CPU runs, and what
``chip_smoke.py`` holds the CUDA kernel to."""

from __future__ import annotations

import torch

from ..block_topk.ref import to_tiles


def hess_update_ref(h: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
                    alpha: float, block: int = 128):
    """h, d, s: (M, N) or (n, M, N). Returns (h + alpha * s, ||h - d||_F
    in f32: a scalar, or (n,))."""
    diff = (h - d).to(torch.float32)
    tiles = to_tiles(diff if diff.dim() == 3 else diff.unsqueeze(0), block)
    l = torch.sqrt(torch.sum(torch.sum(tiles * tiles, dim=2), dim=1))
    return torch.add(h, s, alpha=alpha), l if h.dim() == 3 else l[0]
