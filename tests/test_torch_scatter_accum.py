"""An emulation, in plain torch, of how ``scatter_accumulate``'s CUDA
kernels (``csrc/scatter_accum.cu``) compute the sum, held bit for bit to
the plain version ``scatter_accumulate_ref``:

* the entries (each pair, then its mirror when symmetric) in stream
  order, each with its cell or dropped;
* per pass of the stable counting sort of region ids
  (``accum_count_kernel``, ``accum_scan_kernel``, ``accum_place_kernel``):
  the counts per (chunk, digit), their scan digit-major then chunk, the
  per-warp tables, and each group of 32's leaders taking their digit's
  running start, each entry placed at that start plus its rank among
  lower lanes;
* per sum warp (``accum_sum_kernel``: a region, or a share of one
  wider than a warp's shared memory): its region's bucket from the scan
  (one pass) or the 32-way search (several), its cells from ``init`` or
  0, the bucket's entries that land there added 32 at a time, one round
  per rank among equal cells.

The plans are ``ops.plan``'s own (what the wrapper passes the kernel)
and ``make_plan``'s with forced choices: narrow digits (two and three
passes), narrow regions, short warp segments. The inputs:
``kernels.adversarial``'s K2 cases, its shapes where ``plan`` itself
sorts in two passes, and hypothesis draws. ``test_torch_cuda.py`` holds the CUDA kernels to the
same plain version on a card.
"""

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.kernels.adversarial import (
    SCATTER_CASES,
    TWO_PASS_SHAPES,
    scatter_pairs,
    two_pass_pairs,
)
from repro_torch.kernels.scatter_accum import scatter_accumulate_ref
from repro_torch.kernels.scatter_accum.ops import CHUNK_WARPS, make_plan, plan


def _entries(values, indices, shape, symmetric):
    """(cell, value) of every entry in stream order; cell -1 = dropped."""
    d0, d1 = shape
    cells = d0 * d1
    i = indices.reshape(-1).to(torch.int64)
    v = values.reshape(-1)
    valid = (i >= 0) & (i < cells)
    key = torch.where(valid, i, -1)
    if symmetric:
        r, c = torch.div(i, d1, rounding_mode="floor"), torch.remainder(i, d1)
        mvalid = valid & (r != c) & (c < d0) & (r < d1)
        mirror = torch.where(mvalid, c * d1 + r, -1)
        key = torch.stack([key, mirror], dim=1).reshape(-1)
        v = torch.stack([v, v], dim=1).reshape(-1)
    return key, v


def _region(key, p):
    return torch.where(key < 0, p.regions, key >> p.log_r)


def _group_ranks(d):
    """Per lane of a group of 32: its leader (lowest lane of the same
    value), the leader's count, and its rank among lower lanes
    (``__match_any_sync``, ``__ffs``, ``__popc``)."""
    eq = d[:, None] == d[None, :]
    lane = torch.arange(d.numel())
    leader = eq.to(torch.int64).argmax(dim=1)
    rank = (eq & (lane[None, :] < lane[:, None])).sum(dim=1)
    return leader, eq.sum(dim=1), rank


def _sort_pass(key, val, p, shift):
    """One pass of the stable counting sort, as the three kernels run it;
    returns the pass's output and its scanned counts."""
    ndigit = 1 << p.digit_bits
    pos = torch.arange(p.entries)
    digit = (_region(key, p) >> shift) & (ndigit - 1)
    chunk = pos // (CHUNK_WARPS * p.seg)
    warp = (pos // p.seg) % CHUNK_WARPS
    # accum_count_kernel: counts[chunk][digit]
    counts = torch.zeros((p.chunks, ndigit), dtype=torch.int64)
    counts.index_put_((chunk, digit), torch.ones_like(digit), accumulate=True)
    # accum_scan_kernel: digit-major, then chunk
    flat = counts.T.reshape(-1)
    offsets = (torch.cumsum(flat, 0) - flat).reshape(ndigit, p.chunks).T
    # accum_place_kernel: per-warp counts, then each warp's starts
    table = torch.zeros((p.chunks, CHUNK_WARPS, ndigit), dtype=torch.int64)
    table.index_put_((chunk, warp, digit), torch.ones_like(digit),
                     accumulate=True)
    running = offsets[:, None, :] + torch.cumsum(table, 1) - table
    dest = torch.empty(p.entries, dtype=torch.int64)
    for g0 in range(0, p.entries, 32):          # each warp's groups in order
        sl = slice(g0, min(g0 + 32, p.entries))
        d, c, w = digit[sl], chunk[g0], warp[g0]
        leader, count, rank = _group_ranks(d)
        lanes = torch.arange(d.numel())
        lead = leader == lanes
        start = torch.zeros_like(d)
        start[lead] = running[c, w, d[lead]]
        running[c, w, d[lead]] += count[lead]
        dest[sl] = start[leader] + rank
    assert torch.equal(torch.sort(dest).values, pos), "not a permutation"
    out_key = torch.empty_like(key)
    out_val = torch.empty_like(val)
    out_key[dest] = key
    out_val[dest] = val
    return out_key, out_val, offsets


def _bucket_start(region, g):
    """``bucket_start``: 32 evenly spaced probes per step."""
    lo, hi = 0, region.numel()
    while lo < hi:
        step = -(-(hi - lo) // 32)
        at = lo + step * np.arange(32)
        less = [a < hi and int(region[a]) < g for a in at]
        n = sum(less)
        assert less == [True] * n + [False] * (32 - n)
        if n == 0:
            return lo
        hi = min(hi, lo + n * step)
        lo += (n - 1) * step + 1
    return lo


def _plan(n, k, d0, d1, symmetric, itemsize, **force):
    """``ops.plan``'s plan, or ``make_plan``'s with some of ``plan``'s
    choices (``log_r``, ``digit_bits``, ``seg``) forced."""
    p = plan(n, k, d0, d1, symmetric, itemsize)
    if not force:
        return p
    choice = {"log_r": p.log_r, "digit_bits": p.digit_bits, "seg": p.seg}
    return make_plan(n, k, d0, d1, symmetric, itemsize, **{**choice, **force})


def emulate(values, indices, shape, symmetric=False, init=None, **force):
    d0, d1 = shape
    n, k = values.shape
    p = _plan(n, k, d0, d1, bool(symmetric), values.element_size(), **force)
    key, val = _entries(values, indices, shape, symmetric)
    assert key.numel() == p.entries
    offsets = None
    if p.entries:
        for i in range(p.passes):
            key, val, offsets = _sort_pass(key, val, p, i * p.digit_bits)
        region = _region(key, p)
        # stable by region: each region's entries in stream order
        want = torch.sort(_region(_entries(values, indices, shape,
                                           symmetric)[0], p), stable=True)
        assert torch.equal(region, want.values)
    out = torch.empty(p.cells, dtype=values.dtype)
    side = 1 << p.log_sub
    for sub in range(-(-p.cells // side)):
        g = sub >> (p.log_r - p.log_sub)
        first = sub * side
        ncell = min(side, p.cells - first)
        lo = hi = 0
        if p.entries and p.passes == 1:
            lo, hi = int(offsets[0, g]), int(offsets[0, g + 1])
        elif p.entries:
            lo, hi = _bucket_start(region, g), _bucket_start(region, g + 1)
            assert (lo, hi) == (int(torch.searchsorted(region, g)),
                                int(torch.searchsorted(region, g + 1)))
        acc = (init.reshape(-1)[first:first + ncell].clone() if init is not None
               else torch.zeros(ncell, dtype=values.dtype))
        assert bool((_region(key[lo:hi], p) == g).all())
        for b in range(lo, hi, 32):
            c = key[b:min(b + 32, hi)] - first
            v = val[b:min(b + 32, hi)]
            c = torch.where((c >= 0) & (c < ncell), c, -1)  # this warp's
            _, _, rank = _group_ranks(c)
            for r in range(int(rank.max()) + 1):
                sel = (rank == r) & (c >= 0)
                acc[c[sel]] += v[sel]               # distinct cells
        out[first:first + ncell] = acc
    return out.reshape(d0, d1)


def _same_bits(got, want):
    return torch.equal(got.view(torch.int64 if got.dtype == torch.float64
                                else torch.int32),
                       want.view(torch.int64 if want.dtype == torch.float64
                                 else torch.int32))


# forced plans: narrow digits (several passes), narrow regions, short
# segments (several chunks and warps), regions of 4 sum warps each
FORCED = [{}, {"digit_bits": 2, "seg": 32}, {"digit_bits": 1, "log_r": 5},
          {"log_r": 5, "seg": 64}, {"log_r": 14, "digit_bits": 3}]


@pytest.mark.parametrize("force", FORCED, ids=["plan", "digits2", "digits1",
                                               "narrow", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_emulated_kernel_matches_plain_on_adversarial_pairs(case, dtype, force):
    args = scatter_pairs(case, dtype, seed=23)
    silo = args.pop("zero_silo", None)
    got = emulate(**args, **force)
    want = scatter_accumulate_ref(**args)
    assert _same_bits(got, want)
    if silo is not None:                     # as if the silo sent nothing
        dropped = args["indices"].clone()
        dropped[silo] = -1
        assert _same_bits(want, scatter_accumulate_ref(
            **{**args, "indices": dropped}))


@pytest.mark.parametrize("shape,symmetric,init", [
    ((300, 300), False, False), ((300, 300), True, True),
    ((37, 300), True, False)])
def test_emulated_kernel_matches_plain_at_w8a_width(shape, symmetric, init):
    """142 silos of Top-K pairs on 300-wide rows (w8a's d), f64."""
    rng = np.random.default_rng(24)
    cells = shape[0] * shape[1]
    idx = rng.integers(0, cells, size=(142, 40))
    idx[:, ::2] = rng.integers(0, 64, size=(142, 20)) * 7   # shared cells
    idx[:, -2:] = -1
    vals = rng.standard_normal((142, 40))
    args = dict(values=torch.from_numpy(vals),
                indices=torch.from_numpy(idx.astype(np.int32)), shape=shape,
                symmetric=symmetric,
                init=torch.from_numpy(rng.standard_normal(shape)) if init
                else None)
    assert _same_bits(emulate(**args), scatter_accumulate_ref(**args))


@pytest.mark.parametrize("dtype,shape,symmetric", [
    (torch.float32, TWO_PASS_SHAPES[torch.float32][0], False),
    (torch.float64, TWO_PASS_SHAPES[torch.float64][0], True)],
    ids=["f32-flat", "f64-square-symmetric"])
def test_emulated_kernel_matches_plain_at_two_pass_shapes(dtype, shape,
                                                          symmetric):
    """Shapes with over 2,047 regions, where ``plan`` itself sorts in
    two passes and the sum warps find their buckets by search."""
    args = two_pass_pairs(shape, symmetric, dtype, seed=25)
    n, k = args["values"].shape
    assert plan(n, k, *shape, symmetric, args["values"].element_size()).passes == 2
    assert _same_bits(emulate(**args), scatter_accumulate_ref(**args))


def test_plan_fits_the_kernel():
    """The plans of the paths' shapes and their limits: one sort pass at
    w8a and at the K3 shape (d = 2,048 f64, Top-K k = d over 142 silos),
    a sum warp's cells within its 8 KB of shared memory and at most 4
    sum warps a region, digits of at most 11 bits, segments a multiple
    of 32."""
    w8a = plan(142, 300, 300, 300, True, 8)
    k3 = plan(142, 2048, 2048, 2048, False, 8)
    flat = plan(4, 500, 1, 90000, False, 4)
    huge = plan(4, 1 << 20, 1, (1 << 31) - 1, False, 4)
    for p, itemsize in ((w8a, 8), (k3, 8), (flat, 4), (huge, 4)):
        assert itemsize << p.log_sub <= 8192 and p.log_r - p.log_sub <= 2
        assert 1 <= p.digit_bits <= 11 and p.seg % 32 == 0
        assert p.passes * p.digit_bits >= p.regions.bit_length()
        assert p.chunks * CHUNK_WARPS * p.seg >= p.entries
        # the scratch arrays, 256-byte aligned, one after another
        spans = [(at, at + size) for at, size in zip(p.layout, (
            p.entries * 4, p.entries * itemsize, p.entries * 4,
            p.entries * itemsize, p.chunks * 4 << p.digit_bits,
            4 << p.digit_bits, 4 << p.digit_bits)) if at is not None]
        assert all(at % 256 == 0 for at, _ in spans)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= p.scratch_bytes
        assert (p.layout[2] is None) == (p.passes == 1)
    assert w8a.passes == k3.passes == flat.passes == 1
    assert huge.passes == 2
    assert flat.regions > 1                   # a (1, d1) row splits
    for dtype, shapes in TWO_PASS_SHAPES.items():
        for shape in shapes:
            size = torch.finfo(dtype).bits // 8
            assert plan(8, 2000, *shape, False, size).passes == 2
            assert plan(8, 2000, *shape, True, size).passes == 2


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(n=st.integers(0, 6), k=st.integers(0, 40),
                  d0=st.integers(1, 40), d1=st.integers(1, 40),
                  symmetric=st.booleans(), init=st.booleans(),
                  f64=st.booleans(), seed=st.integers(0, 2**31 - 1),
                  force=st.sampled_from(FORCED))
def test_emulated_kernel_matches_plain_on_drawn_pairs(n, k, d0, d1, symmetric,
                                                      init, f64, seed, force):
    rng = np.random.default_rng(seed)
    cells = d0 * d1
    idx = rng.integers(-3, cells + 3, size=(n, k))
    if k and n > 1:
        idx[1:, : k // 2] = idx[0, : k // 2]         # cells shared by silos
    dtype = np.float64 if f64 else np.float32
    vals = rng.standard_normal((n, k)).astype(dtype)
    vals[rng.random((n, k)) < 0.1] = -0.0
    args = dict(values=torch.from_numpy(vals),
                indices=torch.from_numpy(idx.astype(np.int32)),
                shape=(d0, d1), symmetric=symmetric,
                init=torch.from_numpy(rng.standard_normal((d0, d1))
                                      .astype(dtype)) if init else None)
    assert _same_bits(emulate(**args, **force), scatter_accumulate_ref(**args))
