"""The port's kernel modules against the JAX Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; those are held
here to the Pallas kernel bodies run in interpret mode
(``use_pallas=True, interpret=True``), on the same numpy inputs:

* diff_topk_payload: values and indices exactly (the f32 bisection and
  the flat-order tie rule are reproduced bit for bit), ||D||^2 to
  rtol 1e-11 (tiles summed in another order);
* scatter_accumulate / block_scatter_accumulate: rtol 1e-13 (the Pallas
  kernel sums each chunk by a one-hot matmul, the port in stream order);
* payload_to_dense: bit for bit, on the Pallas kernel's payloads.

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
from repro.kernels.block_topk import block_topk_payload as jax_block_topk_payload
from repro.kernels.block_topk import diff_topk_payload as jax_diff_topk_payload
from repro.kernels.block_topk import payload_to_dense as jax_payload_to_dense
from repro.kernels.scatter_accum import (
    block_scatter_accumulate as jax_block_scatter_accumulate,
)
from repro.kernels.scatter_accum import scatter_accumulate as jax_scatter_accumulate
from repro.kernels.scatter_accum import streamed_slab_update
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.block_topk import diff_topk_payload, payload_to_dense
from repro_torch.kernels.scatter_accum import (
    block_scatter_accumulate,
    scatter_accumulate,
)

# -- diff -> block top-k -> payload (K1) --------------------------------------


def _tie_cluster(n, d, seed):
    """Hessian-diff-like a, b with a planted cluster of equal |D| that
    straddles the k-th place in the first tile, plus a near-tie pair
    (distinct in f64, equal after rounding to f32)."""
    rng = np.random.default_rng(seed)
    a = stacked_diffs(n, d, seed)
    b = 0.1 * rng.standard_normal((n, d, d))
    b[:, :5, :5] = 0.0
    a[:, :5, :5] = 9.0 * np.sign(rng.standard_normal((n, 5, 5)))
    a[:, 6, 7] = 9.0 * (1 + 1e-12)
    return a, b


def _jax_diff_topk(a, b, k, block):
    vals, idx, sq = [], [], []
    for ai, bi in zip(a, b):
        v, i, s = jax_diff_topk_payload(jnp.asarray(ai), jnp.asarray(bi), k=k,
                                        block=block, use_pallas=True,
                                        interpret=True)
        vals.append(np.asarray(v))
        idx.append(np.asarray(i))
        sq.append(float(s))
    return np.stack(vals), np.stack(idx), np.asarray(sq)


@pytest.mark.parametrize("case,k,block,dtype", [
    ("hessian", 8, 128, np.float64),    # a1a width, one ragged tile
    ("random", 8, 128, np.float64),     # 2 x 2 tiles, ragged edge
    ("ties", 8, 128, np.float64),       # tie cluster across the k-th place
    ("ties", 8, 128, np.float32),
    ("random", 64, 8, np.float64),      # k = block^2: every entry kept
    ("random", 100, 8, np.float64),     # k > block^2 clamps to block^2
    ("random", 24, 16, np.float32),
])
def test_diff_topk_payload_matches_pallas_kernel(case, k, block, dtype):
    n, d = (3, 123) if case == "hessian" else (2, 150)
    if case == "ties":
        a, b = _tie_cluster(n, d, seed=1)
    else:
        a, b = stacked_diffs(n, d, seed=2), stacked_diffs(n, d, seed=3)
    a, b = a.astype(dtype), b.astype(dtype)
    with jax.enable_x64(True):
        want_v, want_i, want_sq = _jax_diff_topk(a, b, k, block)
    calls = dict(LAUNCHES)
    vals, idx, sq = diff_topk_payload(torch.from_numpy(a), torch.from_numpy(b),
                                      k=k, block=block)
    assert LAUNCHES == calls          # the CPU path launches nothing
    assert vals.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    rtol = 1e-11 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(sq.numpy(), want_sq, rtol=rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diff_topk_payload_shared_b_matches_pallas_kernel(dtype):
    """One b shared by every silo, as the curvature learner diffs each
    silo's observation against one H: the reference vmaps the kernel over
    the silos with b fixed."""
    a = stacked_diffs(3, 70, seed=9, symmetric=False).astype(dtype)
    b = stacked_diffs(1, 70, seed=10, symmetric=False)[0].astype(dtype)
    with jax.enable_x64(True):
        want_v, want_i, want_sq = _jax_diff_topk(a, np.broadcast_to(b, a.shape),
                                                 20, 32)
    vals, idx, sq = diff_topk_payload(torch.from_numpy(a), torch.from_numpy(b),
                                      k=20, block=32)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_allclose(sq.numpy(), want_sq,
                               rtol=1e-11 if dtype == np.float64 else 1e-5)


def test_diff_topk_payload_keeps_ties_in_flat_order():
    """Inside the bracket, ties fill the remaining slots in flat order,
    and exactly k entries are kept."""
    d = np.zeros((1, 8, 8))
    d[0, 1, 1] = 5.0
    d[0, [0, 2, 3, 5], [4, 0, 3, 1]] = 2.0          # four-way tie, two fit
    vals, idx, _ = diff_topk_payload(torch.from_numpy(d), torch.zeros_like(
        torch.from_numpy(d)), k=3, block=8)
    assert idx.tolist() == [[[9, 4, 16]]]
    assert vals.tolist() == [[[5.0, 2.0, 2.0]]]


# -- scatter_accumulate (K2) ---------------------------------------------------


def _pairs(n, k, numel, seed, pad=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, numel, size=(n, k)).astype(np.int32)
    idx[:, 3] = idx[:, 1]                           # duplicates within a silo
    idx[1, :4] = idx[0, :4]                         # and across silos
    idx[:, -pad:] = -1                              # payload padding
    vals = rng.standard_normal((n, k)).astype(dtype)
    return vals, idx


@pytest.mark.parametrize("shape,symmetric", [
    ((40, 56), False), ((48, 48), False), ((48, 48), True), ((130, 130), True),
])
def test_scatter_accumulate_matches_pallas_kernel(shape, symmetric):
    d0, d1 = shape
    vals, idx = _pairs(4, 300, d0 * d1, seed=4)
    if symmetric:                                  # lower-triangular pairs
        r, c = np.divmod(np.where(idx < 0, 0, idx), d1)
        idx = np.where(idx < 0, -1, np.maximum(r, c) * d1 + np.minimum(r, c))
        idx = idx.astype(np.int32)
        idx[0, 0] = 7 * d1 + 7                      # a diagonal pair
    with jax.enable_x64(True):
        want = np.asarray(jax_scatter_accumulate(
            jnp.asarray(vals), jnp.asarray(idx), shape, use_pallas=True,
            interpret=True, symmetric=symmetric))
    got = scatter_accumulate(torch.from_numpy(vals), torch.from_numpy(idx),
                             shape, symmetric=symmetric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_scatter_accumulate_init_matches_pallas_init_kernel():
    """``init`` seeds the sum, as the Pallas kernel's init variant (the
    streamed slab update) does."""
    shape = (40, 56)
    vals, idx = _pairs(3, 64, 40 * 56, seed=5)
    init = np.random.default_rng(6).standard_normal(shape)
    with jax.enable_x64(True):
        acc = jnp.zeros((40, 128)).at[:, :56].set(jnp.asarray(init))
        want = np.asarray(streamed_slab_update(
            acc, jnp.asarray(vals), jnp.asarray(idx), shape,
            interpret=True))[:, :56]
    got = scatter_accumulate(torch.from_numpy(vals), torch.from_numpy(idx),
                             shape, init=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("symmetric", [False, True])
def test_scatter_accumulate_weight_zero_silo_bit_exact(symmetric):
    """A silo scaled by 0 leaves the sum bit for bit as dropping its
    pairs does (stream-order adds of +-0 change nothing)."""
    vals, idx = _pairs(5, 40, 24 * 24, seed=7)
    r, c = np.divmod(np.where(idx < 0, 0, idx), 24)
    idx = np.where(idx < 0, -1, np.maximum(r, c) * 24 + np.minimum(r, c))
    v, i = torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int32))
    w = torch.tensor([1.0, 0.7, 0.0, 1.0, 0.3], dtype=torch.float64)
    dropped = i.clone()
    dropped[2] = -1
    out = scatter_accumulate(v * w[:, None], i, (24, 24), symmetric=symmetric)
    ref = scatter_accumulate(v * w.index_fill(0, torch.tensor([2]), 1.0)[:, None],
                             dropped, (24, 24), symmetric=symmetric)
    assert torch.equal(out, ref)


# -- block_scatter_accumulate (K4) --------------------------------------------


@pytest.mark.parametrize("grid,block,k", [((1, 1), 128, 8), ((2, 3), 16, 12),
                                          ((3, 3), 128, 8)])
def test_block_scatter_accumulate_matches_pallas_kernel(grid, block, k):
    n, nblk = 4, grid[0] * grid[1]
    vals, idx = _pairs(n * nblk, k, block * block, seed=8, pad=2)
    vals, idx = vals.reshape(n, nblk, k), idx.reshape(n, nblk, k)
    with jax.enable_x64(True):
        want = np.asarray(jax_block_scatter_accumulate(
            jnp.asarray(vals), jnp.asarray(idx), grid, block,
            use_pallas=True, interpret=True))
    got = block_scatter_accumulate(torch.from_numpy(vals),
                                   torch.from_numpy(idx), grid, block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


# -- the payload decoder ------------------------------------------------------


@pytest.mark.parametrize("shape,k", [((300, 123), 16), ((17, 31), 200),
                                     ((256, 128), 1)])
def test_payload_to_dense_matches_reference(shape, k):
    """The Pallas kernel's payload, with a few slots emptied to -1,
    decodes bit for bit as the reference decodes it; a stack of two
    decodes matrix by matrix."""
    x = jax.random.normal(jax.random.PRNGKey(0), shape)
    vals, idx = jax_block_topk_payload(x, k=k, block=128, use_pallas=True,
                                       interpret=True)
    vals, idx = np.array(vals), np.array(idx)
    idx[0, :min(3, k)] = -1                 # empty slots are dropped
    want = np.asarray(jax_payload_to_dense(jnp.asarray(vals),
                                           jnp.asarray(idx), shape,
                                           block=128))
    got = payload_to_dense(torch.from_numpy(vals), torch.from_numpy(idx),
                           shape, block=128)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    stack = payload_to_dense(torch.from_numpy(np.stack([vals, vals])),
                             torch.from_numpy(np.stack([idx, idx])), shape,
                             block=128)
    assert stack.shape == (2, *shape)
    assert torch.equal(stack[0], got) and torch.equal(stack[1], got)
