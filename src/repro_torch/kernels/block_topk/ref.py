"""Plain PyTorch version of the fused diff -> block top-k -> payload
kernel, with the kernel's semantics (not a sort's): an f32 bisection
bracket of the k-th |D| per tile, then exactly k entries — strict
survivors first, then bracket ties, each in flat order. This is what
the CPU runs, and what ``chip_smoke.py`` holds the CUDA kernel to."""

from __future__ import annotations

import torch

BISECT_ROUNDS = 32


def to_tiles(m: torch.Tensor, block: int) -> torch.Tensor:
    """(n, d0, d1) -> (n, tiles, block * block), tiles in row-major grid
    order, zero-padded at the ragged edge."""
    n, d0, d1 = m.shape
    p0, p1 = (-d0) % block, (-d1) % block
    mp = torch.nn.functional.pad(m, (0, p1, 0, p0))
    g0, g1 = mp.shape[1] // block, mp.shape[2] // block
    return (mp.reshape(n, g0, block, g1, block).permute(0, 1, 3, 2, 4)
            .reshape(n, g0 * g1, block * block))


def diff_topk_payload_ref(a: torch.Tensor, b: torch.Tensor, k: int,
                          block: int = 128):
    """a, b: (n, M, N). Returns (values (n, tiles, k), in-tile indices
    (n, tiles, k) int32 with -1 in empty slots, ||a_i - b_i||_F^2 (n,))."""
    tiles = to_tiles(a - b, block)
    n, nblk, bb = tiles.shape
    k = min(int(k), bb)
    sq = torch.sum(tiles * tiles, dim=2).sum(dim=1)
    ax = torch.abs(tiles).to(torch.float32)
    if k >= bb:
        strict = torch.ones_like(ax, dtype=torch.bool)
        tie = torch.zeros_like(strict)
    else:
        hi = torch.amax(ax, dim=2)
        lo = torch.zeros_like(hi)
        for _ in range(BISECT_ROUNDS):
            mid = 0.5 * (lo + hi)
            cnt = torch.sum(ax >= mid.unsqueeze(-1), dim=2)
            too_many = cnt > k
            lo = torch.where(too_many, mid, lo)
            hi = torch.where(too_many, hi, mid)
        strict = ax >= hi.unsqueeze(-1)
        tie = (ax >= lo.unsqueeze(-1)) & ~strict
    n_strict = torch.sum(strict, dim=2, keepdim=True)
    slot = torch.where(
        strict, torch.cumsum(strict, dim=2) - 1,
        torch.where(tie, n_strict + torch.cumsum(tie, dim=2) - 1, k))
    slot = torch.clamp(slot, max=k)             # slot k collects the rest
    flat = torch.arange(bb, dtype=torch.int32, device=a.device).expand_as(slot)
    vals = torch.zeros((n, nblk, k + 1), dtype=tiles.dtype, device=a.device)
    idx = torch.full((n, nblk, k + 1), -1, dtype=torch.int32, device=a.device)
    vals.scatter_(2, slot, tiles)
    idx.scatter_(2, slot, flat)
    return vals[..., :k], idx[..., :k], sq
