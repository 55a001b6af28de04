"""Inputs that stress what the block top-k kernels (K1, K5, K6) and the
block-sparse server sum (K4) must get exactly right: the f32 bracket and
the flat-order tie rule, and the stream order of the sum. ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold each kernel to its plain version on
them, bit for bit. Everything is drawn on the CPU from a seed and moved
to ``device``.
"""

from __future__ import annotations

import torch

# D = a - b per tile: random, a whole tile of zeros, heavy ties (values
# on a grid of 0.5), -0.0 entries, and +-inf entries
TOPK_CASES = ("random", "zeros", "ties", "negzero", "inf")
# pairs per (silo, tile): distinct cells in every silo (the top-k
# kernels' payloads; across silos they meet), cells repeated within a
# silo, and every silo on the same cells with -0.0 and 0 values
SUM_CASES = ("distinct", "repeats", "same_cells")


def topk_inputs(case: str, n: int, m: int, cols: int, dtype: torch.dtype,
                seed: int, device="cpu"):
    """(a (n, m, cols), b (m, cols)) with D = a - b exact: b holds small
    integers and D is a multiple of 2^-12 well inside the type's
    mantissa, so a = D + b rounds to nothing."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.round(torch.randn((n, m, cols), generator=gen,
                                dtype=torch.float64) * 4096) / 4096
    b = torch.randint(-3, 4, (m, cols), generator=gen).to(torch.float64)
    if case == "zeros":
        d[:, :min(m, 40), :min(cols, 40)] = 0.0    # whole small tiles
        d[:, -3:, :] = 0.0
    elif case == "ties":
        d = torch.round(d * 2) / 2                 # a few values, many ties
        d[:, :5, :5] = 9.0 * torch.sign(d[:, :5, :5] + 0.1)
    elif case == "negzero":
        small = d.abs() < 0.7
        d[small] = -0.0
        b[small.any(dim=0)] = 0.0                  # -0.0 - 0.0 = -0.0
    elif case == "inf":
        d[:, 3, 4] = float("inf")
        d[:, 7, 7] = -float("inf")
        d[0, 1, :] = float("inf")                  # more infs than some k
    elif case != "random":
        raise ValueError(f"unknown case {case!r}")
    a = d + b
    if case == "negzero":
        a[(d == 0) & (b == 0) & torch.signbit(d)] = -0.0
    return a.to(dtype).to(device), b.to(dtype).to(device)


def block_sparse_pairs(case: str, n: int, tiles: int, k: int, block: int,
                       dtype: torch.dtype, seed: int, device="cpu"):
    """(values, indices) of shape (n, tiles, k <= block^2) in the
    BlockSparsePayload layout. Every case also carries -1 padding and
    indices outside [0, block^2), which the sum drops."""
    gen = torch.Generator().manual_seed(seed)
    bb = block * block
    idx = torch.empty((n, tiles, k), dtype=torch.int64)
    for s in range(n):
        for t in range(tiles):
            # same_cells: one permutation per tile, whatever the silo
            cells = torch.randperm(bb, generator=torch.Generator().manual_seed(
                seed * 7919 + t) if case == "same_cells" else gen)
            idx[s, t] = cells[:k]
    if case == "repeats":
        idx[:, :, min(5, k - 1)] = idx[:, :, min(2, k - 1)]
        idx[:, :, k // 2:k // 2 + 3] = idx[:, :, :1]
    idx[:, :, -3:] = -1                                  # padding
    idx[:, :, k // 3] = bb + 17                          # out of range
    idx[:, :, k // 4] = -5
    vals = torch.randn((n, tiles, k), generator=gen, dtype=torch.float64)
    if case == "same_cells":
        vals[0] = -0.0
        vals[-1, :, ::7] = 0.0
    return (vals.to(dtype).to(device),
            idx.to(torch.int32).contiguous().to(device))
