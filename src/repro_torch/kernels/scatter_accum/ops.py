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
from ..tuning.cache import lookup
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


def default_digit_bits(cells: int, log_r: int) -> int:
    """The fewest sort passes of at most 11-bit digits over the region
    ids, then the narrowest digit that many passes allow."""
    bits = max(1, (-(-cells // (1 << log_r))).bit_length())
    passes = -(-bits // MAX_DIGIT_BITS)
    return -(-bits // passes)


@functools.lru_cache(maxsize=256)
def plan(n: int, k: int, d0: int, d1: int, symmetric: bool,
         itemsize: int) -> ScatterPlan:
    """The untuned plan: regions of about 64 entries each and at most
    2,047 of them (one sort pass of 11-bit digits, the dropped entries'
    id included), of 32 cells up to 4 sum warps' worth; about 128 chunks
    (a block each) until a warp's segment reaches 8,192 entries."""
    entries = n * k * (2 if symmetric else 1)
    cells = d0 * d1
    sub_max = (SUM_WARP_BYTES // itemsize).bit_length() - 1
    target = min(2047, max(1, entries // 64))
    log_r = max(5, (-(-cells // target) - 1).bit_length())
    log_r = min(log_r, sub_max + 2)
    seg = -(-entries // (CHUNK_WARPS * 128))
    seg = min(8192, max(32, -(-seg // 32) * 32))
    return make_plan(n, k, d0, d1, symmetric, itemsize, log_r,
                     default_digit_bits(cells, log_r), seg)


def plan_error(p: ScatterPlan, dtype) -> str | None:
    """Why the kernel's launcher would refuse plan ``p`` (``make_plan``'s,
    from a region width in [0, 30], a digit width in [1, 11] and a
    positive multiple of 32 entries a segment), or why one of its
    launches is over a block's shared memory or registers; None when it
    launches."""
    from ..resources import launch_resources, within_budget

    if p.passes * p.digit_bits > 31:
        return f"{p.passes} passes of {p.digit_bits} bits exceed 31 bits"
    if p.chunks > 0x7FFFFFFF:
        return f"{p.chunks} chunks exceed the grid"
    if not within_budget(launch_resources("scatter_accumulate", dtype=dtype,
                                          plan=p)):
        return "a launch is over a block's shared memory or registers"
    return None


@functools.lru_cache(maxsize=256)
def _fields_plan(n: int, k: int, d0: int, d1: int, symmetric: bool, dtype,
                 log_r: int | None, digit_bits: int | None,
                 seg: int | None) -> tuple:
    """(the plan with these fields, the others from the untuned plan; the
    untuned plan; why the first cannot launch, or None)."""
    itemsize = dtype.itemsize
    base = plan(n, k, d0, d1, symmetric, itemsize)
    log_r = base.log_r if log_r is None else int(log_r)
    if not 0 <= log_r <= 30:
        return None, base, f"log_r {log_r} outside [0, 30]"
    digit_bits = default_digit_bits(d0 * d1, log_r) if digit_bits is None \
        else int(digit_bits)
    if not 1 <= digit_bits <= MAX_DIGIT_BITS:
        return None, base, (f"digit_bits {digit_bits} outside "
                            f"[1, {MAX_DIGIT_BITS}]")
    seg = base.seg if seg is None else int(seg)
    if seg < 32 or seg % 32:
        return None, base, f"seg {seg} is not a positive multiple of 32"
    p = make_plan(n, k, d0, d1, symmetric, itemsize, log_r, digit_bits, seg)
    return p, base, plan_error(p, dtype)


def resolve_plan(n: int, k: int, d0: int, d1: int, symmetric: bool, dtype,
                 device=None, log_r: int | None = None,
                 digit_bits: int | None = None,
                 seg: int | None = None) -> ScatterPlan:
    """The plan ``scatter_accumulate`` launches on ``device``: the fields
    given explicitly (the others from the untuned plan), else the tuning
    cache's winner for (shape, k, n, dtype, device kind), else the untuned
    ``plan``. An explicit plan the kernel cannot take raises; a cached one
    gives way to the untuned plan, never to the plain version."""
    explicit = not (log_r is None and digit_bits is None and seg is None)
    if not explicit:
        cfg = lookup("scatter_accumulate", (d0, d1), k, n, dtype, device)
        if cfg is None:
            return plan(n, k, d0, d1, bool(symmetric), dtype.itemsize)
        log_r, digit_bits, seg = cfg.log_r, cfg.digit_bits, cfg.seg
    p, base, err = _fields_plan(n, k, d0, d1, bool(symmetric), dtype, log_r,
                                digit_bits, seg)
    if err is None:
        return p
    if explicit:
        raise ValueError(f"scatter_accumulate: plan log_r={log_r}, "
                         f"digit_bits={digit_bits}, seg={seg} cannot launch: "
                         f"{err}")
    return base


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
                       init: torch.Tensor | None = None,
                       log_r: int | None = None, digit_bits: int | None = None,
                       seg: int | None = None) -> torch.Tensor:
    """Dense (d0, d1) SUM of n silos' (value, row-major flat index)
    pairs, values/indices (n, k). Indices outside the matrix (-1
    padding) are dropped, duplicates add, ``symmetric`` mirrors each
    off-diagonal pair, ``init`` seeds the sum. Each cell adds its pairs
    in stream order (silo, slot), with no float atomics, so every plan
    gives the same bits. ``log_r``, ``digit_bits`` and ``seg`` fix the
    kernel's plan; left None, ``resolve_plan`` picks it (tuning cache,
    else the untuned plan)."""
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
    p = resolve_plan(n, k, d0, d1, bool(symmetric), values.dtype,
                     values.device, log_r, digit_bits, seg)
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


# The streaming rule: a silo slab's (value, index) pair stream takes at
# most this many bytes of card memory. The reference streams once the
# stack outgrows its 8 MiB VMEM budget; K2 reads its pairs from device
# memory, so here a slab is bounded by the card's memory instead.
STREAM_SLAB_BYTES = 1 << 30


def silo_chunk_for(k: int, value_dtype=torch.float64,
                   index_dtype=torch.int32,
                   budget: int = STREAM_SLAB_BYTES) -> int:
    """The most silos whose (value, index) pairs fit ``budget`` bytes,
    at least one."""
    pair = (value_dtype.itemsize
            + index_dtype.itemsize)
    return max(1, int(budget // max(1, int(k) * pair)))


def streamed_slab_update(acc: torch.Tensor, values: torch.Tensor,
                         indices: torch.Tensor, shape,
                         log_r: int | None = None,
                         digit_bits: int | None = None,
                         seg: int | None = None) -> torch.Tensor:
    """One silo slab added to the running server sum ``acc`` (d0, d1):
    K2 seeded with ``acc`` (``init``). Each cell starts from its running
    value and adds the slab's pairs in stream order, so chaining slabs
    adds every cell's pairs in the stacked call's order: the result is
    the stacked sum bit for bit. No mirror here: a symmetric sum mirrors
    once, after the last slab."""
    return scatter_accumulate(values, indices, shape, init=acc, log_r=log_r,
                              digit_bits=digit_bits, seg=seg)


def streamed_scatter_accumulate(values, indices, shape,
                                silo_chunk: int | None = None,
                                symmetric: bool = False, device=None,
                                log_r: int | None = None,
                                digit_bits: int | None = None,
                                seg: int | None = None) -> torch.Tensor:
    """Dense (d0, d1) SUM of n silo payloads (n, k), streamed from host
    memory in slabs of ``silo_chunk`` silos (default ``silo_chunk_for``):
    the card holds the accumulator and at most two slabs, whatever n is.
    ``values``/``indices`` are CPU tensors or numpy arrays; ``device``
    (default: theirs) runs the sum, K2 on a card. The next slab's copy is
    issued before the current slab's kernel. ``symmetric`` mirrors the
    lower-triangular sum once at the end (c + c^T - diag(c)), as the
    reference's streamed path does. The plan is resolved once against
    the whole stack (explicit fields, the tuning cache, the untuned plan)
    and every slab launches it. Bit for bit ``scatter_accumulate`` of the
    stack without ``symmetric``, and with it on lower-triangular pairs."""
    values = torch.as_tensor(values)
    indices = torch.as_tensor(indices)
    n, k = values.shape
    d0, d1 = (int(s) for s in shape)
    device = values.device if device is None else torch.device(device)
    if silo_chunk is None:
        silo_chunk = silo_chunk_for(k, values.dtype, indices.dtype)
    silo_chunk = max(1, int(silo_chunk))
    fields = {}
    if device.type == "cuda":
        p = resolve_plan(n, k, d0, d1, False, values.dtype, device, log_r,
                         digit_bits, seg)
        fields = dict(log_r=p.log_r, digit_bits=p.digit_bits, seg=p.seg)

    def fetch(start: int):
        end = min(start + silo_chunk, n)
        return (values[start:end].to(device, non_blocking=True).contiguous(),
                indices[start:end].to(device, non_blocking=True).contiguous())

    starts = range(0, n, silo_chunk)
    acc = torch.zeros((d0, d1), dtype=values.dtype, device=device)
    nxt = fetch(0) if n else None
    for pos in range(len(starts)):
        cur_v, cur_i = nxt
        if pos + 1 < len(starts):
            nxt = fetch(starts[pos + 1])
        acc = streamed_slab_update(acc, cur_v, cur_i, (d0, d1), **fields)
    if symmetric:
        acc = acc + acc.T - torch.diag(torch.diag(acc))
    return acc


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
