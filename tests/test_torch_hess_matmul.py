"""The port's fused Hessian update and f32 tiled matmul (plain versions
on the CPU) against the JAX Pallas kernels they replace, run in
interpret mode, on the same numpy inputs:

* hess_update (K7): H + alpha * S exactly (one rounding: XLA fuses the
  reference's multiply-add, and the port computes it as a fused
  multiply-add too), ||H - D||_F to rtol 1e-6 (f32 squares summed per
  tile, in another order);
* tiled_matmul (K8): 1e-5 relative to the largest entry (f32 products
  summed in another order; an entry that cancels to near 0 carries the
  absolute error of the large ones, so the measure is norm-wise);
* the PowerSGD power iteration from the reference's own starting
  subspace: 1e-5 relative to the largest entry, through the kernel's
  wrapper and through the plain ``powersgd_rank_r_ref``.

``test_torch_cuda.py`` holds the CUDA kernels to these plain versions on
a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.kernels.hess_update import hess_update as jax_hess_update
from repro.kernels.tiled_matmul import powersgd_rank_r as jax_powersgd_rank_r
from repro.kernels.tiled_matmul import (
    powersgd_rank_r_ref as jax_powersgd_rank_r_ref,
)
from repro.kernels.tiled_matmul import tiled_matmul as jax_tiled_matmul
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.hess_update import hess_update
from repro_torch.kernels.tiled_matmul import (
    powersgd_rank_r,
    powersgd_rank_r_ref,
    subspace_iteration,
    tiled_matmul,
)


@pytest.mark.parametrize("shape,block,dtype,alpha", [
    ((300, 123), 128, np.float64, 0.37),   # ragged edge tiles
    ((300, 123), 128, np.float32, 0.37),
    ((40, 56), 16, np.float64, 1.0),
    ((64, 64), 32, np.float32, 1e-3),
])
def test_hess_update_matches_pallas_kernel(shape, block, dtype, alpha):
    rng = np.random.default_rng(21)
    h, d, s = (rng.standard_normal(shape).astype(dtype) for _ in range(3))
    with jax.enable_x64(True):
        want_out, want_l = jax_hess_update(jnp.asarray(h), jnp.asarray(d),
                                           jnp.asarray(s), alpha, block=block,
                                           interpret=True)
        want_out, want_l = np.asarray(want_out), float(want_l)
    calls = dict(LAUNCHES)
    out, l = hess_update(torch.from_numpy(h), torch.from_numpy(d),
                         torch.from_numpy(s), alpha, block=block)
    assert LAUNCHES == calls
    assert out.dtype == torch.from_numpy(h).dtype and l.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_allclose(float(l), want_l, rtol=1e-6)


def test_hess_update_stack_is_per_matrix():
    """A stack (n, M, N) gives each matrix's update and norm."""
    rng = np.random.default_rng(22)
    h, d, s = (torch.from_numpy(rng.standard_normal((3, 30, 20)))
               for _ in range(3))
    out, l = hess_update(h, d, s, 0.5, block=16)
    assert l.shape == (3,)
    for i in range(3):
        oi, li = hess_update(h[i], d[i], s[i], 0.5, block=16)
        assert torch.equal(out[i], oi)
        torch.testing.assert_close(l[i], li, rtol=1e-6, atol=0)


def _assert_rel_close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("m,k,n,dtype", [
    (150, 70, 130, np.float32),
    (64, 300, 2, np.float32),       # a power-iteration product
    (37, 19, 5, np.float64),        # f64 in, computed in f32
])
def test_tiled_matmul_matches_pallas_kernel(m, k, n, dtype):
    rng = np.random.default_rng(23)
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    with jax.enable_x64(True):
        want = np.asarray(jax_tiled_matmul(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    got = tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(a).dtype
    _assert_rel_close(got.numpy(), want)
    # a transposed view is read as is
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).T
    _assert_rel_close(tiled_matmul(torch.from_numpy(a), bt).numpy(), want)


@pytest.mark.parametrize("shape,r", [((60, 60), 1), ((48, 90), 2)])
def test_powersgd_power_iteration_matches_reference(shape, r):
    """From the reference's own starting subspace (its jax.random draw,
    orthonormalized), the port's power iteration gives the reference's
    rank-r approximation."""
    rng = np.random.default_rng(24)
    m = rng.standard_normal(shape).astype(np.float32)
    m[:, 0] *= 6.0                                  # a dominant direction
    q = jax.random.normal(jax.random.PRNGKey(0), (shape[1], r), jnp.float32)
    q = np.asarray(jnp.linalg.qr(q)[0])
    want = np.asarray(jax_powersgd_rank_r(jnp.asarray(m), r, interpret=True))
    got = subspace_iteration(torch.from_numpy(m), torch.from_numpy(q.copy()))
    _assert_rel_close(got.numpy(), want)
    # the port's own start: a rank-r matrix of the same shape and type
    own = powersgd_rank_r(torch.from_numpy(m), r, seed=0)
    assert own.shape == shape and own.dtype == torch.float32
    assert int(torch.linalg.matrix_rank(own.double(), atol=1e-4)) == r


@pytest.mark.parametrize("shape,r", [((60, 60), 1), ((48, 90), 2)])
def test_powersgd_rank_r_ref_matches_reference(shape, r):
    """``powersgd_rank_r_ref`` handed the reference's Gaussian start (its
    ``PRNGKey(0)`` draw) gives the reference's ``powersgd_rank_r_ref`` to
    1e-5 of the largest entry in f32; drawn from a generator, a rank-r
    matrix; with neither, an error."""
    rng = np.random.default_rng(25)
    m = rng.standard_normal(shape).astype(np.float32)
    m[:, 0] *= 6.0                                  # a dominant direction
    q0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (shape[1], r),
                                    jnp.float32))
    want = np.asarray(jax_powersgd_rank_r_ref(jnp.asarray(m), r))
    calls = dict(LAUNCHES)
    got = powersgd_rank_r_ref(torch.from_numpy(m), r, q0=torch.from_numpy(q0))
    assert LAUNCHES == calls and got.dtype == torch.float32
    _assert_rel_close(got.numpy(), want)
    own = powersgd_rank_r_ref(torch.from_numpy(m), r,
                              generator=torch.Generator().manual_seed(0))
    assert own.shape == shape
    assert int(torch.linalg.matrix_rank(own.double(), atol=1e-4)) == r
    with pytest.raises(ValueError, match="q0 or a generator"):
        powersgd_rank_r_ref(torch.from_numpy(m), r)
