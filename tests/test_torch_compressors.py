"""The port's compressors against ``repro.core.compressors`` on shared
numpy inputs (f64): payload parity, the Top-K tie order, and
``aggregate`` == mean of ``decompress`` for every family in the slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import stacked_diffs
from repro.core import compressors as jc
from repro_torch.core import compressors as tc

N, D = 5, 40
# (family, level) for every registered family of the port
FAMILIES = [("topk", 37), ("topk-sym", 37), ("blocktopk", 6), ("rankr", 2),
            ("identity", None), ("zero", None)]


def _block(comp):
    """Small tiles so a 40 x 40 matrix spans a ragged 3 x 3 grid."""
    if isinstance(comp, (jc.BlockTopK, tc.BlockTopK)):
        return type(comp)(k_per_block=comp.k_per_block, block=16)
    return comp


def _both(family, level):
    return (_block(tc.make_compressor(family, level)),
            _block(jc.make_compressor(family, level)))


def test_registry_matches_reference_for_the_slice():
    for name in tc.available_compressors():
        assert name in jc.available_compressors()
    for family, level in FAMILIES:
        port, ref = _both(family, level)
        with jax.enable_x64(True):
            want = ref.spec((D, D))
        assert tuple(port.spec((D, D))) == tuple(want)
        assert tc.alpha_for(port, (D, D)) == jc.alpha_for(ref, (D, D))
    assert tc.alpha_for(tc.TopK(16), (D, D), "contract") == pytest.approx(
        jc.alpha_for(jc.TopK(16), (D, D), "contract"), rel=1e-15)


@pytest.mark.parametrize("family,level", FAMILIES)
def test_compress_decompress_match_reference(family, level):
    m = stacked_diffs(N, D, seed=20)
    port, ref = _both(family, level)
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(lambda x: ref(x, None))(jnp.asarray(m)))
    got = port(torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    if family in ("topk", "topk-sym", "blocktopk"):
        with jax.enable_x64(True):
            jp = jax.vmap(lambda x: ref.compress(x, None))(jnp.asarray(m))
        tp = port.compress(torch.from_numpy(m))
        np.testing.assert_array_equal(tp.indices.numpy(), np.asarray(jp.indices))
        np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
        assert tp.universe == jp.universe


@pytest.mark.parametrize("family,level", FAMILIES)
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_equals_mean_of_decompress(family, level, weighted):
    """The server's payload-space mean equals decompress-then-mean, and
    the reference's own aggregate."""
    m = stacked_diffs(N, D, seed=21)
    w = np.array([1.0, 0.0, 0.5, 2.0, 1.0]) if weighted else None
    port, ref = _both(family, level)
    pay = port.compress(torch.from_numpy(m))
    wt = None if w is None else torch.from_numpy(w)
    got = port.aggregate(pay, (D, D), weights=wt)
    dense = port.decompress(pay, (D, D))
    scale = torch.ones(N, dtype=torch.float64) if wt is None else wt
    expect = torch.mean(dense * scale[:, None, None], dim=0)
    torch.testing.assert_close(got, expect, rtol=1e-12, atol=1e-12)
    with jax.enable_x64(True):
        jpay = jax.vmap(lambda x: ref.compress(x, None))(jnp.asarray(m))
        want = np.asarray(ref.aggregate(jpay, (D, D), weights=None if w is None
                                        else jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_rankr_svd_variant_matches_reference():
    """Rank-R on a non-symmetric matrix (``symmetric=False``: top singular
    triplets) decodes to the reference's matrix."""
    m = stacked_diffs(N, D, seed=25, symmetric=False)
    with jax.enable_x64(True):
        ref = jc.RankR(3, symmetric=False)
        want = np.asarray(jax.vmap(lambda x: ref(x, None))(jnp.asarray(m)))
    port = tc.RankR(3, symmetric=False)
    got = port(torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    pay = port.compress(torch.from_numpy(m))
    torch.testing.assert_close(port.aggregate(pay, (D, D)),
                               torch.mean(got, dim=0), rtol=1e-12, atol=1e-12)


def test_topk_ties_break_toward_lower_index_like_jax():
    """torch.topk's tie order differs from jax.lax.top_k's; the port's
    TopK follows JAX (lower flat index first)."""
    x = np.array([[1.0, 3.0, 2.0, 3.0, 1.0, 3.0, 0.0, 0.0]])
    _, torch_idx = torch.topk(torch.from_numpy(x[0]), 7)
    _, jax_idx = jax.lax.top_k(jnp.asarray(x[0]), 7)
    assert np.asarray(jax_idx).tolist() == [1, 3, 5, 2, 0, 4, 6]
    pay = tc.TopK(7).compress(torch.from_numpy(x))
    assert pay.indices.tolist() == [np.asarray(jax_idx).tolist()]
    # torch.topk alone may order the tie at |1| the other way round
    assert sorted(torch_idx.tolist()) == sorted(np.asarray(jax_idx).tolist())


def test_symmetric_topk_ties_on_hessian_diff():
    """A symmetric diff has |D_rc| = |D_cr| everywhere: plain Top-K ties
    at its boundary, and the port keeps the reference's choice."""
    m = stacked_diffs(N, D, seed=22)
    for k in (1, 7, 40, 41):
        with jax.enable_x64(True):
            want = jax.vmap(lambda x: jc.TopK(k).compress(x, None))(
                jnp.asarray(m))
        got = tc.TopK(k).compress(torch.from_numpy(m))
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))


def test_block_fused_diff_payloads_equal_compress_on_tie_free_data():
    """The fused uplink (kernel semantics) and ``compress`` (sort
    semantics) keep the same entries on tie-free data."""
    a, b = stacked_diffs(N, D, seed=23, symmetric=False), np.zeros((N, D, D))
    comp = tc.BlockTopK(k_per_block=6, block=16)
    pay, norms = comp.fused_diff_payloads(torch.from_numpy(a),
                                          torch.from_numpy(b))
    ref = comp.compress(torch.from_numpy(a))
    torch.testing.assert_close(comp.decompress(pay, (D, D)),
                               comp.decompress(ref, (D, D)), rtol=0, atol=0)
    np.testing.assert_allclose(norms.numpy(),
                               np.linalg.norm(a, axis=(1, 2)), rtol=1e-13)


def test_scale_payload_and_registry_errors():
    from repro_torch.engine import Oracles, make_method

    pay = tc.RankR(1).compress(torch.from_numpy(stacked_diffs(N, D, seed=24)))
    scaled = tc.scale_payload(pay, torch.arange(N, dtype=torch.float64))
    assert torch.equal(scaled.middle[:, 0], pay.middle[:, 0] * torch.arange(N))
    assert torch.equal(scaled.left, pay.left)
    with pytest.raises(ValueError, match="unknown compressor"):
        tc.make_compressor("signsgd", 1)
    assert tc.make_compressor("powersgd", 1) == tc.PowerSGD(r=1, iters=2)
    method = make_method("fednl", Oracles(None, None, None),
                         tc.make_compressor("zero"), option=2)
    assert method.bits_per_round(D) == D * 64 + 64
