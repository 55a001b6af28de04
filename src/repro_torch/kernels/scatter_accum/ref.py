"""Plain PyTorch versions of the payload-space server sums, with the
kernels' add order: every output cell sums the pairs that land on it in
stream order (silo, then slot), a symmetric pair's mirror right after
the pair itself. This is what the CPU runs, and what ``chip_smoke.py``
holds the CUDA kernels to."""

from __future__ import annotations

import torch


def scatter_accumulate_ref(values: torch.Tensor, indices: torch.Tensor,
                           shape, symmetric: bool = False,
                           init: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (d0, d1) sum of (n, k) (value, row-major flat index) pairs;
    indices outside [0, d0 * d1) (the -1 padding) are dropped and
    duplicates add. ``symmetric`` lands each off-diagonal pair at (r, c)
    and (c, r), a diagonal one once. ``init`` seeds the sum."""
    d0, d1 = (int(s) for s in shape)
    numel = d0 * d1
    v = values.reshape(-1)
    i = indices.reshape(-1).to(torch.int64)
    valid = (i >= 0) & (i < numel)
    if symmetric:
        r, c = torch.div(i, d1, rounding_mode="floor"), torch.remainder(i, d1)
        mirror = c * d1 + r
        mvalid = valid & (r != c) & (c < d0) & (r < d1)
        # interleave pair and mirror so the stream order is kept
        i = torch.stack([i, mirror], dim=1).reshape(-1)
        v = torch.stack([v, v], dim=1).reshape(-1)
        valid = torch.stack([valid, mvalid], dim=1).reshape(-1)
    i = torch.where(valid, i, numel)            # slot numel collects the rest
    acc = torch.zeros(numel + 1, dtype=values.dtype, device=values.device)
    if init is not None:
        acc[:numel] = init.reshape(-1)
    acc.index_add_(0, i, v)
    return acc[:numel].reshape(d0, d1)


def block_scatter_accumulate_ref(values: torch.Tensor, indices: torch.Tensor,
                                 grid, block: int) -> torch.Tensor:
    """Dense (gm * block, gn * block) sum of (n, tiles, k) block-sparse
    payloads (row-major tiles, in-tile flat indices, -1 padding)."""
    gm, gn = (int(g) for g in grid)
    bb = block * block
    nblk = values.shape[-2]
    v = values.transpose(0, 1).reshape(-1)      # tile-major, then (silo, slot)
    i = indices.transpose(0, 1).reshape(nblk, -1).to(torch.int64)
    i = torch.where((i >= 0) & (i < bb), i, bb)
    i = (i + (bb + 1) * torch.arange(nblk, device=i.device)[:, None]).reshape(-1)
    acc = torch.zeros(nblk * (bb + 1), dtype=values.dtype,
                      device=values.device)
    acc.index_add_(0, i, v)
    tiles = acc.reshape(nblk, bb + 1)[:, :bb]
    return (tiles.reshape(gm, gn, block, block).permute(0, 2, 1, 3)
            .reshape(gm * block, gn * block))
