"""Inputs that stress what the block top-k kernels (K1, K5, K6) and the
server sums (K2, K4) must get exactly right: the f32 bracket and the
flat-order tie rule, and the stream order of the sums. ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold each kernel to its plain version on
them, bit for bit, and ``tests/test_torch_scatter_accum.py`` holds an
emulation of K2's algorithm to it. Everything is drawn on the CPU from a
seed and moved to ``device``.
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
# K2's pairs: every pair on one cell; every silo on the diagonal,
# symmetric; all -1; indices past the matrix (and below -1); n * k a
# multiple of no chunk or region size; a (1, 90,000) row; symmetric on a
# 30 x 70 matrix (mirrors outside it); init of -0.0 with -0.0 values; a
# silo scaled by 0; 142 silos on the same hot cells (the w8a pattern)
SCATTER_CASES = ("one_cell", "diagonal", "all_padding", "out_of_range",
                 "ragged", "flat", "rect_symmetric", "negzero_init",
                 "zero_silo", "hot_cells")


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


def scatter_pairs(case: str, dtype: torch.dtype, seed: int,
                  device="cpu") -> dict:
    """Keyword arguments of ``scatter_accumulate`` (values, indices (n, k)
    int32, shape, symmetric, init) for one case of ``SCATTER_CASES``;
    "zero_silo" also gives ``zero_silo``, the silo whose values are
    scaled by 0."""
    gen = torch.Generator().manual_seed(seed)
    n, k, shape, symmetric, init = 5, 120, (40, 40), False, None
    if case == "ragged":
        n, k, shape = 7, 37, (53, 41)
    elif case == "flat":
        n, k, shape = 4, 500, (1, 90000)
    elif case == "rect_symmetric":
        n, k, shape, symmetric = 5, 200, (30, 70), True
    elif case == "hot_cells":
        n, k, shape, symmetric = 142, 60, (300, 300), True
    elif case == "one_cell":
        n, k = 6, 700
    elif case in ("diagonal", "negzero_init", "zero_silo"):
        symmetric = True
    cells = shape[0] * shape[1]
    idx = torch.randint(0, cells, (n, k), generator=gen)
    vals = torch.randn((n, k), generator=gen, dtype=torch.float64)
    if case == "one_cell":
        idx[:] = 7 * shape[1] + 3
    elif case == "diagonal":
        i = torch.randint(0, shape[0], (n, k), generator=gen)
        idx = i * shape[1] + i
    elif case == "all_padding":
        idx[:] = -1
        init = torch.randn(shape, generator=gen, dtype=torch.float64)
    elif case == "out_of_range":
        idx[:, ::3] = cells + torch.randint(0, 1000, (n, k), generator=gen)[:, ::3]
        idx[:, 1::7] = -torch.randint(1, 1000, (n, k), generator=gen)[:, 1::7]
        idx[0, :4] = torch.tensor([cells, 2**31 - 1, -2**31, -1])
    elif case == "flat":
        hot = torch.randint(0, cells, (50,), generator=gen)
        idx[:, ::2] = hot[torch.randint(0, 50, (n, k), generator=gen)][:, ::2]
    elif case == "negzero_init":
        init = torch.full(shape, -0.0, dtype=torch.float64)
        init[::3, ::2] = 1.5
        vals[:, ::2] = -0.0
        idx[:, -10:] = -1
    elif case == "zero_silo":
        vals[2] = vals[2] * 0.0                       # +0.0 and -0.0
    elif case == "hot_cells":
        # lower-triangular picks, half of them from 40 cells every silo
        # picks (runs of up to n adds on one cell)
        hot = torch.randint(0, cells, (40,), generator=gen)
        idx[:, ::2] = hot[torch.randint(0, 40, (n, k), generator=gen)][:, ::2]
        idx[:, -3:] = -1
    elif case != "rect_symmetric" and case != "ragged":
        raise ValueError(f"unknown case {case!r}")
    if case in ("negzero_init", "zero_silo", "hot_cells"):
        r, c = idx // shape[1], idx % shape[1]      # lower-triangular pairs
        idx = torch.where(idx >= 0, torch.maximum(r, c) * shape[1]
                          + torch.minimum(r, c), idx)
    out = dict(values=vals.to(dtype).to(device),
               indices=idx.to(torch.int32).contiguous().to(device),
               shape=shape, symmetric=symmetric,
               init=None if init is None else init.to(dtype).to(device))
    if case == "zero_silo":
        out["zero_silo"] = 2
    return out


# K2's shapes where ``scatter_accumulate``'s plan sorts in two passes
# (over 2,047 regions: above 2,047 * 8,192 cells in f32, 2,047 * 4,096
# in f64): a flat row and a square, per dtype
TWO_PASS_SHAPES = {torch.float32: ((1, 20_000_000), (4_500, 4_500)),
                   torch.float64: ((3_000, 3_000), (1, 10_000_000))}


def two_pass_pairs(shape, symmetric: bool, dtype: torch.dtype, seed: int,
                   device="cpu") -> dict:
    """Keyword arguments of ``scatter_accumulate`` for 8 silos of 2,000
    pairs on a ``TWO_PASS_SHAPES`` matrix: a quarter of each silo's
    cells from 64 cells every silo picks, a repeat within each silo,
    -1 padding and indices past the matrix; lower-triangular and seeded
    by ``init`` when symmetric."""
    gen = torch.Generator().manual_seed(seed)
    n, k = 8, 2000
    cells = shape[0] * shape[1]
    idx = torch.randint(0, cells, (n, k), generator=gen)
    hot = torch.randint(0, cells, (64,), generator=gen)
    idx[:, ::4] = hot[torch.randint(0, 64, (n, k), generator=gen)][:, ::4]
    if symmetric:
        r, c = idx // shape[1], idx % shape[1]
        idx = torch.maximum(r, c) * shape[1] + torch.minimum(r, c)
    idx[:, 5] = idx[:, 2]
    idx[:, -9:-3] = cells + torch.arange(6)
    idx[:, -3:] = -1
    vals = torch.randn((n, k), generator=gen, dtype=torch.float64)
    init = (torch.randn(shape, generator=gen, dtype=torch.float64)
            if symmetric else None)
    return dict(values=vals.to(dtype).to(device),
                indices=idx.to(torch.int32).contiguous().to(device),
                shape=shape, symmetric=symmetric,
                init=None if init is None else init.to(dtype).to(device))
