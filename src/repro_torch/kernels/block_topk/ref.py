"""Plain PyTorch versions of the block top-k kernels, with the kernels'
semantics (not a sort's): an f32 bisection bracket of the k-th |x| per
tile, then — for a payload — exactly k entries: strict survivors first,
then bracket ties, each in flat order; for the dense variant, the
entries at or above the bracket's upper end. This is what the CPU runs,
and what ``chip_smoke.py`` holds the CUDA kernels to."""

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


def from_tiles(tiles: torch.Tensor, shape, block: int) -> torch.Tensor:
    """(n, tiles, block * block) -> (n, d0, d1), cropping the padding."""
    d0, d1 = (int(s) for s in shape)
    g0, g1 = -(-d0 // block), -(-d1 // block)
    n = tiles.shape[0]
    out = (tiles.reshape(n, g0, g1, block, block).permute(0, 1, 3, 2, 4)
           .reshape(n, g0 * block, g1 * block))
    return out[:, :d0, :d1]


def _bracket(ax: torch.Tensor, k: int):
    """Per-tile bisection bracket (lo, hi) on f32 magnitudes (n, tiles,
    bb), with count(ax >= hi) <= k <= count(ax >= lo)."""
    hi = torch.amax(ax, dim=2)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ROUNDS):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum(ax >= mid.unsqueeze(-1), dim=2)
        too_many = cnt > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    return lo, hi


def _payload(tiles: torch.Tensor, k: int, bisect_all: bool = False):
    """(n, tiles, bb) -> k (value, in-tile flat index) pairs per tile,
    -1 in empty slots. With k >= bb every entry is kept in flat order,
    unless ``bisect_all``: then the bracket orders them too."""
    n, nblk, bb = tiles.shape
    ax = torch.abs(tiles).to(torch.float32)
    if k >= bb and not bisect_all:
        strict = torch.ones_like(ax, dtype=torch.bool)
        tie = torch.zeros_like(strict)
    else:
        lo, hi = _bracket(ax, k)
        strict = ax >= hi.unsqueeze(-1)
        tie = (ax >= lo.unsqueeze(-1)) & ~strict
    n_strict = torch.sum(strict, dim=2, keepdim=True)
    slot = torch.where(
        strict, torch.cumsum(strict, dim=2) - 1,
        torch.where(tie, n_strict + torch.cumsum(tie, dim=2) - 1, k))
    slot = torch.clamp(slot, max=k)             # slot k collects the rest
    flat = torch.arange(bb, dtype=torch.int32,
                        device=tiles.device).expand_as(slot)
    vals = torch.zeros((n, nblk, k + 1), dtype=tiles.dtype,
                       device=tiles.device)
    idx = torch.full((n, nblk, k + 1), -1, dtype=torch.int32,
                     device=tiles.device)
    vals.scatter_(2, slot, tiles)
    idx.scatter_(2, slot, flat)
    return vals[..., :k], idx[..., :k]


def diff_topk_payload_ref(a: torch.Tensor, b: torch.Tensor, k: int,
                          block: int = 128, tile_sums: bool = False):
    """a: (n, M, N), b: (n, M, N) or one (M, N) shared by every silo.
    Returns (values (n, tiles, k), in-tile indices (n, tiles, k) int32
    with -1 in empty slots, ||a_i - b_i||_F^2 (n,), or with ``tile_sums``
    its per-tile terms (n, tiles))."""
    tiles = to_tiles(a - b, block)
    k = min(int(k), tiles.shape[2])
    sq = torch.sum(tiles * tiles, dim=2)
    vals, idx = _payload(tiles, k)
    return vals, idx, sq if tile_sums else sq.sum(dim=1)


def block_topk_payload_ref(x: torch.Tensor, k: int, block: int = 128,
                           bisect_all: bool = False):
    """x: (n, M, N). Returns (values, in-tile indices), both
    (n, tiles, min(k, block^2)), -1 in empty slots."""
    tiles = to_tiles(x, block)
    return _payload(tiles, min(int(k), tiles.shape[2]), bisect_all)


def block_topk_ref(x: torch.Tensor, k: int, block: int = 128) -> torch.Tensor:
    """x: (n, M, N) -> x where |x| >= the tile's bracket top, else 0
    (fewer than k survive inside a tie cluster); x itself when k covers
    the tile."""
    tiles = to_tiles(x, block)
    if k >= tiles.shape[2]:
        return x.clone()
    ax = torch.abs(tiles).to(torch.float32)
    _, hi = _bracket(ax, int(k))
    kept = torch.where(ax >= hi.unsqueeze(-1), tiles, torch.zeros_like(tiles))
    return from_tiles(kept, x.shape[1:], block)


def payload_to_dense(vals: torch.Tensor, idx: torch.Tensor, shape,
                     block: int = 128) -> torch.Tensor:
    """The dense compressed matrix of a (values, indices) payload in the
    kernels' layout, (tiles, k) for one matrix or (n, tiles, k) for a
    stack; -1 indices are dropped. Decoded by the one block-sparse
    decoder, ``core.compressors.BlockTopK.decompress``: the kernel
    payload is a ``BlockSparsePayload``."""
    from ...core.compressors import BlockSparsePayload, BlockTopK

    one = vals.dim() == 2
    codec = BlockTopK(k_per_block=int(vals.shape[-1]), block=block)
    dense = codec.decompress(
        BlockSparsePayload(values=vals[None] if one else vals,
                           indices=idx[None] if one else idx,
                           universe=block * block), shape)
    return dense[0] if one else dense
