"""The port's block top-k payload and dense kernels (plain versions on the
CPU) against the JAX Pallas kernels they replace, run in interpret mode
(``use_pallas=True, interpret=True``), on the same numpy inputs:

* block_topk_payload (K5): values and indices exactly — the f32
  bisection bracket and the flat-order tie rule are reproduced bit for
  bit, ragged edges included (the masked edge acts as zero padding);
* block_topk (K6): the dense output exactly;
* BlockTopKThreshold.compress: values and indices exactly as the JAX
  class, whose selection the port's K5 kernel runs;
* the CUDA kernels' bracket: an emulation of their radix select (the
  (k+1)-th largest f32 magnitude by three digit passes, then 32 scalar
  bisection steps) against ``ref.py``'s 32-round count bisection, bit
  for bit.

For finite input every payload slot fills (count(|x| >= lo) >= k), so
-1 marks no slot here; the zero entries of a tile with fewer than k
nonzeros fill the slots in flat order instead.

``test_torch_cuda.py`` holds the CUDA kernels to these plain versions on
a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import stacked_diffs
from repro.core.compressors import BlockTopKThreshold as JaxBlockTopKThreshold
from repro.kernels.block_topk import block_topk as jax_block_topk
from repro.kernels.block_topk import block_topk_payload as jax_block_topk_payload
from repro_torch.core import BlockTopKThreshold, make_compressor
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.block_topk import (
    block_topk,
    block_topk_payload,
    diff_topk_payload,
    to_tiles,
)
from repro_torch.kernels.block_topk.ref import BISECT_ROUNDS, _bracket


def _inputs(case, n, shape, seed, dtype):
    """n matrices: random, a planted tie cluster straddling the k-th
    place of the first tile, or a few real entries per tile (the rest of
    the tile is zeros, as a 1-D tensor's (1, N) view has)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape)
    if case == "ties":
        x[:, :5, :5] = 9.0 * np.sign(rng.standard_normal((n, 5, 5)))
        x[:, 6, 7] = 9.0 * (1 + 1e-12)           # equal to 9 in f32
    return x.astype(dtype)


def _jax_payload(x, k, block):
    vals, idx = [], []
    for xi in x:
        v, i = jax_block_topk_payload(jnp.asarray(xi), k=k, block=block,
                                      use_pallas=True, interpret=True)
        vals.append(np.asarray(v))
        idx.append(np.asarray(i))
    return np.stack(vals), np.stack(idx)


@pytest.mark.parametrize("case,shape,k,block,dtype", [
    ("random", (150, 150), 8, 128, np.float64),   # 2 x 2 tiles, ragged
    ("ties", (150, 150), 8, 128, np.float64),     # ties across the k-th place
    ("ties", (40, 40), 8, 16, np.float32),
    ("random", (40, 24), 64, 8, np.float64),      # k = block^2: whole tile
    ("random", (20, 20), 100, 8, np.float32),     # k > block^2 clamps
    ("random", (1, 70), 200, 32, np.float32),     # 32 real entries per tile
    ("random", (3, 45), 24, 16, np.float32),
])
def test_block_topk_payload_matches_pallas_kernel(case, shape, k, block, dtype):
    x = _inputs(case, 2, shape, seed=11, dtype=dtype)
    with jax.enable_x64(True):
        want_v, want_i = _jax_payload(x, k, block)
    calls = dict(LAUNCHES)
    vals, idx = block_topk_payload(torch.from_numpy(x), k=k, block=block)
    assert LAUNCHES == calls          # the CPU path launches nothing
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    # one matrix at a time gives the same rows
    v0, i0 = block_topk_payload(torch.from_numpy(x[0]), k=k, block=block)
    assert torch.equal(v0, vals[0]) and torch.equal(i0, idx[0])


def test_block_topk_payload_is_the_diff_payload_against_zero():
    """K1(x, 0) and K5(x) select the same entries in the same slots,
    which is what the optimizer's first refresh relies on (H = 0)."""
    x = torch.from_numpy(_inputs("ties", 3, (40, 70), seed=12,
                                 dtype=np.float32))
    v5, i5 = block_topk_payload(x, k=20, block=16)
    v1, i1, _ = diff_topk_payload(x, torch.zeros(40, 70), k=20, block=16)
    assert torch.equal(v1, v5) and torch.equal(i1, i5)


@pytest.mark.parametrize("case,shape,k,block,dtype", [
    ("random", (150, 150), 8, 128, np.float64),
    ("ties", (150, 150), 8, 128, np.float64),     # fewer than k survive
    ("ties", (40, 40), 8, 16, np.float32),
    ("random", (40, 24), 64, 8, np.float32),      # k = block^2: a copy
    ("random", (20, 20), 100, 8, np.float64),     # k > block^2: a copy
    ("random", (3, 45), 24, 16, np.float32),
])
def test_block_topk_dense_matches_pallas_kernel(case, shape, k, block, dtype):
    x = _inputs(case, 2, shape, seed=13, dtype=dtype)
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jax_block_topk(jnp.asarray(xi), k=k,
                                                   block=block,
                                                   interpret=True))
                         for xi in x])
    got = block_topk(torch.from_numpy(x), k=k, block=block)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "ties" and block == 128:
        # the threshold keeps |x| >= hi only: the 26-way cluster at the
        # k-th place survives whole or not at all, never exactly k
        assert np.count_nonzero(want[0, :128, :128]) != k
    assert torch.equal(block_topk(torch.from_numpy(x[1]), k=k, block=block),
                       got[1])


@pytest.mark.parametrize("case,shape,k,block,dtype", [
    ("random", (150, 150), 8, 128, np.float64),
    ("ties", (40, 40), 8, 16, np.float32),
    ("random", (40, 24), 64, 8, np.float64),      # k = block^2, ragged
    ("random", (1, 70), 2048, 32, np.float32),    # k > block^2, ragged
])
def test_block_topk_threshold_compress_matches_jax_class(case, shape, k,
                                                         block, dtype):
    """Values and indices as the JAX class gives them — also where k
    covers the tile and the class still orders it by the bracket."""
    x = _inputs(case, 2, shape, seed=14, dtype=dtype)
    jax_comp = JaxBlockTopKThreshold(k_per_block=k, block=block)
    with jax.enable_x64(True):
        want = [jax_comp.compress(jnp.asarray(xi)) for xi in x]
        want_v = np.stack([np.asarray(p.values) for p in want])
        want_i = np.stack([np.asarray(p.indices) for p in want])
    got = BlockTopKThreshold(k_per_block=k, block=block).compress(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.indices.numpy(), want_i)
    np.testing.assert_array_equal(got.values.numpy(), want_v)
    assert got.universe == block * block


def test_block_topk_threshold_registry_and_aggregate():
    """``blocktopk-threshold`` builds the class; its payloads decode and
    aggregate like every block-sparse payload."""
    comp = make_compressor("blocktopk-threshold", 6)
    assert isinstance(comp, BlockTopKThreshold) and comp.k_per_block == 6
    x = torch.from_numpy(stacked_diffs(3, 20, seed=15))
    comp = BlockTopKThreshold(k_per_block=6, block=8)
    p = comp.compress(x)
    dense = comp.decompress(p, (20, 20))
    torch.testing.assert_close(comp.aggregate(p, (20, 20)),
                               dense.mean(dim=0), rtol=1e-13, atol=1e-15)
    assert int(torch.count_nonzero(dense[0, :8, :8])) == 6


# -- the CUDA kernels' bracket, emulated --------------------------------------

INF_KEY = 0x7F800000
DIGITS = ((20, 11), (10, 10), (0, 10))    # the kernels' radix passes


def _radix_select(keys: torch.Tensor, k: int):
    """The kernels' select on one tile's keys (f32 bit patterns of |x|
    without the sign bit, int64): the (k+1)-th largest non-NaN key, found
    digit by digit from histograms and suffix counts; None if fewer than
    k + 1 keys are not NaN."""
    keys = keys[keys <= INF_KEY]
    prefix, pmask, rank = 0, 0, k
    for shift, bits in DIGITS:
        nbins = 1 << bits
        live = keys[(keys & pmask) == prefix]
        hist = torch.bincount((live >> shift) & (nbins - 1), minlength=nbins)
        if int(hist.sum()) <= rank:
            return None
        above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0]) - hist
        digit = int(torch.nonzero((above <= rank) & (rank < above + hist))[0])
        rank -= int(above[digit])
        prefix |= digit << shift
        pmask |= (nbins - 1) << shift
    return prefix


def _emulated_bracket(ax: torch.Tensor, k: int):
    """(lo, hi) as the kernels compute them from f32 magnitudes ax: hi
    starts at the largest non-NaN magnitude (0 if none), then 32 scalar
    steps mid = 0.5f * (lo + hi), lo = mid if mid <= v else hi = mid, in
    f32."""
    keys = ax.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    v_key = _radix_select(keys, k)
    if v_key is not None:
        order = torch.sort(keys[keys <= INF_KEY], descending=True).values
        assert v_key == int(order[k])                   # the order statistic
    finite = ax[~torch.isnan(ax)]
    half = torch.tensor(0.5, dtype=torch.float32)
    lo = torch.tensor(0.0, dtype=torch.float32)
    hi = finite.max() if finite.numel() else torch.tensor(0.0)
    v = torch.tensor([v_key or 0], dtype=torch.int32).view(torch.float32)[0]
    for _ in range(BISECT_ROUNDS):
        mid = half * (lo + hi)
        if v_key is not None and bool(mid <= v):
            lo = mid
        else:
            hi = mid
    return lo, hi


def _tiles(case: str, block: int, seed: int) -> torch.Tensor:
    """A few tiles of f32 magnitudes (ragged: a (block + 3) square matrix
    leaves zero padding in three of its four tiles)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, block + 3, block + 3))
    if case == "ties":
        x = np.round(x * 2) / 2
    elif case == "zeros":
        x[0] = 0.0
        x[1, : block // 2] = -0.0
    elif case == "negzero":
        x[np.abs(x) < 0.6] = -0.0
    elif case == "nan":
        x[0, ::3, ::5] = np.nan
        x[1, :4, :] = np.nan
    elif case == "inf":
        x[0, 1, 2] = np.inf
        x[1, :3, :7] = -np.inf
    elif case == "subnormal":
        x *= 1e-39                              # f32 subnormals and zeros
    elif case == "lognormal":
        x = np.sign(x) * np.exp(4.0 * rng.standard_normal(x.shape))
    tiles = to_tiles(torch.from_numpy(x.astype(np.float32)), block)
    return torch.abs(tiles).reshape(-1, block * block)


@pytest.mark.parametrize("kind", ["0", "1", "bb-1", "bb", "bb+3"])
@pytest.mark.parametrize("case", ["random", "ties", "zeros", "negzero", "nan",
                                  "inf", "subnormal", "lognormal"])
def test_radix_select_bracket_matches_count_bisection(case, kind):
    """The bracket from one order statistic equals ``ref.py``'s 32 rounds
    of count bisection bit for bit, at blocks 8 and 16 and k from 0 to
    past the tile. A NaN never counts and never wins the max (the
    kernels' rule); ``_bracket`` sees it as -1, which no mid >= 0
    counts."""
    for block in (8, 16):
        bb = block * block
        k = {"0": 0, "1": 1, "bb-1": bb - 1, "bb": bb, "bb+3": bb + 3}[kind]
        for tile in _tiles(case, block, seed=block + len(case)):
            if bool(torch.isnan(tile).all()):
                continue
            lo, hi = _emulated_bracket(tile, k)
            ax = torch.where(torch.isnan(tile), -1.0, tile)[None, None]
            want_lo, want_hi = _bracket(ax, k)
            assert torch.equal(want_lo.reshape(()).view(torch.int32),
                               lo.view(torch.int32))
            assert torch.equal(want_hi.reshape(()).view(torch.int32),
                               hi.view(torch.int32))
