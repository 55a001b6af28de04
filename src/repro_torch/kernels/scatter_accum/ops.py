"""Payload-space server sums: ``scatter_accumulate`` (SparsePayload,
global flat indices) and ``block_scatter_accumulate`` (BlockSparsePayload,
in-tile indices), each the dense SUM over silos from one accumulator.

On a CUDA tensor each launches its kernel in ``csrc/scatter_accum.cu``;
on a CPU tensor it runs the plain version in ``ref.py``. There is no
other path: a CUDA tensor the kernel cannot take raises.

``scatter_accumulate``'s kernel sorts the pairs stably by output region
and sums each region's bucket in stream order; ``plan`` sizes it (region
width, digit width of the sort, entries per warp), ``make_plan`` derives
the rest and lays out the scratch the wrapper allocates, and the kernel's
launcher takes that plan as it is.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import _cuda
from .ref import block_scatter_accumulate_ref, scatter_accumulate_ref

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# scatter_accumulate's kernel (csrc/scatter_accum.cu): warps per chunk of
# the entry stream, the widest digit of one sort pass, and the bytes of
# cells one sum warp holds in shared memory
CHUNK_WARPS = 8
MAX_DIGIT_BITS = 11
SUM_WARP_BYTES = 8 * 1024
_ALIGN = 256


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """How ``scatter_accumulate``'s kernel cuts one call: ``entries``
    (pairs, and their mirrors when symmetric) in stream order; regions
    of 2^``log_r`` consecutive flat cells (``regions`` of them, id
    ``regions`` for dropped entries), each summed by warps of
    2^``log_sub`` cells; a stable counting sort of the region ids in
    ``passes`` passes of ``digit_bits``; chunks of ``CHUNK_WARPS`` warps
    of ``seg`` entries. ``layout`` gives the byte offset of each scratch
    array (keys0, vals0, keys1, vals1: the sorted (cell, value) entries;
    counts per chunk and digit, totals and starts per digit; None where
    unused) in ``scratch_bytes``."""

    entries: int
    cells: int
    log_r: int
    log_sub: int
    regions: int
    digit_bits: int
    passes: int
    seg: int
    chunks: int
    layout: tuple
    scratch_bytes: int


def make_plan(n: int, k: int, d0: int, d1: int, symmetric: bool,
              itemsize: int, log_r: int, digit_bits: int,
              seg: int) -> ScatterPlan:
    """Every field of the plan with regions of 2^``log_r`` cells, digits
    of ``digit_bits`` and segments of ``seg`` entries, and the scratch
    layout. The kernel's launcher takes these fields as they are and
    checks them against the scratch it is given."""
    entries = n * k * (2 if symmetric else 1)
    cells = d0 * d1
    sub_max = (SUM_WARP_BYTES // itemsize).bit_length() - 1
    log_sub = min(log_r, sub_max)
    regions = -(-cells // (1 << log_r))
    passes = -(-regions.bit_length() // digit_bits)  # ids 0..regions
    chunks = -(-entries // (CHUNK_WARPS * seg))
    ndigit = 1 << digit_bits
    sizes = (entries * 4, entries * itemsize,
             entries * 4 if passes > 1 else 0,
             entries * itemsize if passes > 1 else 0,
             chunks * ndigit * 4, ndigit * 4, ndigit * 4)
    layout, at = [], 0
    for size in sizes:
        layout.append(at if size else None)
        at += -(-size // _ALIGN) * _ALIGN
    return ScatterPlan(entries, cells, log_r, log_sub, regions, digit_bits,
                       passes, seg, chunks, tuple(layout), at)


@functools.lru_cache(maxsize=256)
def plan(n: int, k: int, d0: int, d1: int, symmetric: bool,
         itemsize: int) -> ScatterPlan:
    """Regions of about 64 entries each and at most 2,047 of them (one
    sort pass of 11-bit digits, the dropped entries' id included), of 32
    cells up to 4 sum warps' worth; about 128 chunks (a block each)
    until a warp's segment reaches 8,192 entries."""
    entries = n * k * (2 if symmetric else 1)
    cells = d0 * d1
    sub_max = (SUM_WARP_BYTES // itemsize).bit_length() - 1
    target = min(2047, max(1, entries // 64))
    log_r = max(5, (-(-cells // target) - 1).bit_length())
    log_r = min(log_r, sub_max + 2)
    bits = max(1, (-(-cells // (1 << log_r))).bit_length())
    passes = -(-bits // MAX_DIGIT_BITS)
    seg = -(-entries // (CHUNK_WARPS * 128))
    seg = min(8192, max(32, -(-seg // 32) * 32))
    return make_plan(n, k, d0, d1, symmetric, itemsize, log_r,
                     -(-bits // passes), seg)


def _check_pairs(name: str, values, indices, ndim: int) -> None:
    if values.device.type != "cuda" or indices.device != values.device:
        raise ValueError(f"{name}: values and indices must lie on one CUDA "
                         f"device, got {values.device} and {indices.device}")
    if values.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32/float64, got {values.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 indices, got {indices.dtype}")
    if values.dim() != ndim or values.shape != indices.shape:
        raise ValueError(f"{name}: expected values and indices of one "
                         f"{ndim}-d shape, got {tuple(values.shape)} and "
                         f"{tuple(indices.shape)}")
    if not (values.is_contiguous() and indices.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")


def scatter_accumulate(values: torch.Tensor, indices: torch.Tensor, shape,
                       symmetric: bool = False,
                       init: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (d0, d1) SUM of n silos' (value, row-major flat index)
    pairs, values/indices (n, k). Indices outside the matrix (-1
    padding) are dropped, duplicates add, ``symmetric`` mirrors each
    off-diagonal pair, ``init`` seeds the sum. Each cell adds its pairs
    in stream order (silo, slot), with no float atomics."""
    d0, d1 = (int(s) for s in shape)
    if values.device.type == "cpu" and indices.device.type == "cpu":
        return scatter_accumulate_ref(values, indices, (d0, d1),
                                      symmetric=symmetric, init=init)
    _check_pairs("scatter_accumulate", values, indices, 2)
    if init is not None and (init.shape != (d0, d1) or init.dtype != values.dtype
                             or init.device != values.device
                             or not init.is_contiguous()):
        raise ValueError("scatter_accumulate: init must be a contiguous "
                         f"({d0}, {d1}) tensor like values")
    if d0 * d1 >= 2**31:
        raise ValueError(f"scatter_accumulate: ({d0}, {d1}) has more cells "
                         "than int32 flat indices address")
    n, k = values.shape
    if n * k * (2 if symmetric else 1) > 0x7FFFFFC0:
        raise ValueError(f"scatter_accumulate: {n} x {k} pairs exceed the "
                         "kernel's int32 entry offsets")
    p = plan(n, k, d0, d1, bool(symmetric), values.element_size())
    out = torch.empty((d0, d1), dtype=values.dtype, device=values.device)
    scratch = torch.empty(p.scratch_bytes, dtype=torch.uint8,
                          device=values.device)
    base = scratch.data_ptr()
    ptrs = [None if at is None else base + at for at in p.layout]
    fn = getattr(_cuda.library("scatter_accum"),
                 f"scatter_accumulate_{_SUFFIX[values.dtype]}")
    with _cuda.on(values.device):
        err = fn(values.data_ptr(), indices.data_ptr(),
                 None if init is None else init.data_ptr(), out.data_ptr(),
                 base, p.scratch_bytes, *ptrs, n, k, d0, d1,
                 int(bool(symmetric)), p.log_r, p.log_sub, p.regions,
                 p.digit_bits, p.passes, p.seg, p.chunks, _cuda.stream())
    _cuda.check(err, "scatter_accumulate")
    _cuda.LAUNCHES["scatter_accumulate"] += 1
    return out


def block_scatter_accumulate(values: torch.Tensor, indices: torch.Tensor,
                             grid, block: int) -> torch.Tensor:
    """Dense (gm * block, gn * block) SUM of n block-sparse silo payloads,
    values/indices (n, gm * gn, k) in the BlockSparsePayload layout."""
    gm, gn = (int(g) for g in grid)
    if values.device.type == "cpu" and indices.device.type == "cpu":
        return block_scatter_accumulate_ref(values, indices, (gm, gn), block)
    _check_pairs("block_scatter_accumulate", values, indices, 3)
    n, nblk, k = values.shape
    if nblk != gm * gn:
        raise ValueError(f"block_scatter_accumulate: {nblk} tiles for a "
                         f"{gm} x {gn} grid")
    out = torch.empty((gm * block, gn * block), dtype=values.dtype,
                      device=values.device)
    fn = getattr(_cuda.library("scatter_accum"),
                 f"block_scatter_accumulate_{_SUFFIX[values.dtype]}")
    with _cuda.on(values.device):
        err = fn(values.data_ptr(), indices.data_ptr(), out.data_ptr(), n,
                 nblk, k, block, gn, _cuda.stream())
    _cuda.check(err, "block_scatter_accumulate")
    _cuda.LAUNCHES["block_scatter_accumulate"] += 1
    return out
