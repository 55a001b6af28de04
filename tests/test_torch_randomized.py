"""The port's randomized compressors and solvers against the JAX
reference (f64).

* Rand-K, random dithering and natural sparsification on the
  reference's own draws (``_torch_replay.compressor_draws``): every
  payload field bitwise, but dithering's norm, a sum that the two
  libraries reduce in their own orders (held to 4 ulp); the decoded
  matrices and the server means.
* PowerSGD from the reference's start subspace: factors to 1e-12
  relative.
* ``spec`` and ``ab_constants`` field by field for every family.
* Unbiasedness and omega under the port's own torch draws: a mean over
  N_STAT draws of one matrix within 5 standard errors of the matrix,
  and the mean squared error within 10 % of its expectation.
* ``solve_cubic_subproblem`` to 1e-10 on indefinite, PSD and g = 0
  inputs; ``backtracking``'s step exactly on a1a; the quadratic oracles.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import (
    jax_a1a_oracles,
    port_problem,
    reference_a1a,
    stacked_diffs,
)
from _torch_replay import compressor_draws, powersgd_start
from repro.core import compressors as jc
from repro.core import linalg as jlinalg
from repro.core import newton as jnewton
from repro.core import objectives as jobj
from repro_torch.core import compressors as tc
from repro_torch.core import linalg as tlinalg
from repro_torch.core import newton as tnewton
from repro_torch.core import objectives as tobj

N, D = 5, 40
RANDOMIZED = [("randk", 57), ("dithering", 4), ("natural", 0.3)]
ALL_FAMILIES = RANDOMIZED + [
    ("powersgd", 2), ("topk", 37), ("topk-sym", 37), ("blocktopk", 6),
    ("blocktopk-threshold", 6), ("rankr", 2), ("identity", None),
    ("zero", None)]
N_STAT = 20000


def _keys(seed, n=N):
    with jax.enable_x64(True):
        return jax.random.split(jax.random.PRNGKey(seed), n)


def _ref_payload(ref, m, keys):
    with jax.enable_x64(True):
        return jax.vmap(ref.compress)(jnp.asarray(m), keys)


def _bits(t: torch.Tensor) -> np.ndarray:
    """An array's bit patterns (so -0.0 and +0.0 differ)."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


@pytest.mark.parametrize("shape", [(D, D), (D,)])
@pytest.mark.parametrize("family,level", RANDOMIZED)
def test_randomized_payload_matches_reference_on_its_draws(family, level,
                                                           shape):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((N, *shape))
    m[:, 0] = 0.0                                     # exact zeros
    m[1] = 0.0                                        # an all-zero silo
    port, ref = tc.make_compressor(family, level), jc.make_compressor(
        family, level)
    keys = _keys(9)
    want = _ref_payload(ref, m, keys)
    got = port.apply(torch.from_numpy(m), compressor_draws(port, keys, shape))
    assert type(got).__name__ == type(want).__name__
    for field in (f.name for f in dataclasses.fields(got)):
        g, w = getattr(got, field), getattr(want, field)
        if not isinstance(g, torch.Tensor):
            assert g == w, field
        elif field == "norm":
            np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), 4)
        else:
            assert g.numpy().dtype == np.asarray(w).dtype, field
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=field)
    with jax.enable_x64(True):
        dense = np.asarray(jax.vmap(lambda p: ref.decompress(p, shape))(want))
        agg = np.asarray(ref.aggregate(want, shape,
                                       weights=jnp.arange(N) % 2 * 1.0))
    np.testing.assert_allclose(port.decompress(got, shape).numpy(), dense,
                               rtol=1e-14, atol=1e-14)
    w = torch.arange(N, dtype=torch.float64) % 2
    np.testing.assert_allclose(port.aggregate(got, shape, weights=w).numpy(),
                               agg, rtol=1e-13, atol=1e-14)


def test_natural_sparsification_drops_negatives_to_plus_zero():
    port = tc.NaturalSparsification(p=0.5)
    m = -torch.ones((1, 64), dtype=torch.float64)
    pay = port.apply(m, torch.arange(64)[None] % 2 == 0)
    assert not bool(torch.signbit(pay.values[0, 1::2]).any())


@pytest.mark.parametrize("symmetric", [True, False])
def test_powersgd_matches_reference(symmetric):
    m = stacked_diffs(N, D, seed=23, symmetric=symmetric)
    m[2] = 0.0                                 # the rescale's 1e-30 guard
    port, ref = tc.PowerSGD(r=2), jc.PowerSGD(r=2)
    want = _ref_payload(ref, m, _keys(1))
    start = torch.from_numpy(np.array(powersgd_start(port, D)))
    got = port.apply(torch.from_numpy(m), start)
    for field in ("left", "right", "middle"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-12, atol=1e-12, err_msg=field)
    with jax.enable_x64(True):
        agg = np.asarray(ref.aggregate(want, (D, D)))
    np.testing.assert_allclose(port.aggregate(got, (D, D)).numpy(), agg,
                               rtol=1e-12, atol=1e-12)
    # its own start, from its seed: a contraction in the Frobenius norm
    own = port.decompress(port.compress(torch.from_numpy(m)), (D, D))
    norms = torch.linalg.matrix_norm(own)
    assert bool((norms <= torch.linalg.matrix_norm(torch.from_numpy(m))
                 * (1 + 1e-12)).all())


@pytest.mark.parametrize("family,level", ALL_FAMILIES)
def test_spec_and_ab_constants_match_reference(family, level):
    port, ref = tc.make_compressor(family, level), jc.make_compressor(
        family, level)
    for shape in ((D, D), (D,), (7, 300)):
        if len(shape) == 1 and family in ("rankr", "powersgd", "blocktopk",
                                          "blocktopk-threshold", "topk-sym"):
            continue
        assert tuple(port.spec(shape)) == tuple(ref.spec(shape)), shape
        for alpha in (1.0, 0.5):
            if port.spec(shape).delta == 0.0 and alpha == 1.0:
                continue                          # Zero: 6/delta
            assert (tc.ab_constants(port, shape, alpha)
                    == jc.ab_constants(ref, shape, alpha))
        assert tc.alpha_for(port, shape) == jc.alpha_for(ref, shape)


def test_randomized_compressors_need_a_generator():
    m = torch.ones((2, 4, 4), dtype=torch.float64)
    for family, level in RANDOMIZED:
        with pytest.raises(ValueError, match="randomized"):
            tc.make_compressor(family, level).compress(m)
    gen = torch.Generator().manual_seed(0)
    assert tc.RandK(3).compress(m, gen).values.shape == (2, 3)


@pytest.mark.parametrize("family,level", [("randk", 9), ("randk", 5),
                                          ("dithering", 2), ("natural", 0.3)])
def test_unbiased_with_omega_under_torch_draws(family, level):
    """E[C(M)] = M and E||C(M) - M||^2 <= omega ||M||^2 (Def 3.2) over
    N_STAT of the port's own draws of one 6 x 6 matrix."""
    rng = np.random.default_rng(2)
    mat = torch.from_numpy(rng.standard_normal((6, 6)))
    comp = tc.make_compressor(family, level)
    gen = torch.Generator().manual_seed(11)
    out = comp(mat.expand(N_STAT, 6, 6), gen)
    err2 = torch.sum((out - mat) ** 2, dim=(1, 2))
    omega = comp.spec((6, 6)).omega
    bound = omega * float(torch.sum(mat**2))
    assert float(err2.mean()) <= 1.1 * bound
    if family != "dithering":          # Rand-K and natural: equality
        assert float(err2.mean()) >= 0.9 * bound
    se = out.std(dim=0) / N_STAT**0.5
    assert bool((torch.abs(out.mean(dim=0) - mat) <= 5 * se + 1e-12).all())


@pytest.mark.parametrize("k", [2, 4])
def test_randk_draw_is_a_uniform_subset(k):
    """Rand-K's draw of k of 6 entries over N_STAT rows (k = 2 by rows
    drawn again where they repeat an index, k^2 <= 6; k = 4 by the k
    least of 6 uniform keys): k distinct indices a row, and each of the
    C(6, k) subsets within 5 standard deviations of its expected
    count."""
    gen = torch.Generator().manual_seed(5)
    idx = tc.RandK(k).draw(N_STAT, (6,), torch.float64, gen)
    assert idx.shape == (N_STAT, k)
    srt = torch.sort(idx, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    assert 0 <= int(idx.min()) and int(idx.max()) < 6
    counts = torch.bincount(torch.sum(2**srt, dim=1), minlength=64)
    counts = counts[counts > 0].double()
    p = 1.0 / math.comb(6, k)
    assert counts.numel() == math.comb(6, k)
    sd = (N_STAT * p * (1 - p)) ** 0.5
    assert float(torch.max(torch.abs(counts - N_STAT * p))) <= 5 * sd


def test_cubic_subproblem_matches_reference():
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    cases = {
        "indefinite": q @ np.diag(np.linspace(-2.0, 3.0, 30)) @ q.T,
        "psd": q @ np.diag(np.linspace(0.0, 3.0, 30)) @ q.T,
    }
    g = rng.standard_normal(30)
    for name, h in cases.items():
        for gg in (g, np.zeros(30)):
            for m_cubic in (0.5, 7.0):
                with jax.enable_x64(True):
                    want = np.asarray(jlinalg.solve_cubic_subproblem(
                        jnp.asarray(gg), jnp.asarray(h), m_cubic))
                got = tlinalg.solve_cubic_subproblem(
                    torch.from_numpy(gg), torch.from_numpy(h), m_cubic)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-10, err_msg=name)
                if not gg.any():
                    assert not bool(got.any())


def test_backtracking_matches_reference_on_a1a():
    """The accepted step on a1a's objective: at s = 0, after several
    halvings, and none passing (an ascent direction: gamma^30)."""
    ref = reference_a1a()
    prob = jax_a1a_oracles()
    pprob = port_problem(ref)
    d = ref["d"]
    with jax.enable_x64(True):
        val = lambda x: jobj.global_value(x, prob["data"])
        x0 = jnp.zeros(d)
        g = jnp.mean(prob["grad"](x0), axis=0)
        h = jnp.mean(prob["hess"](x0), axis=0)
        newton_dir = -jnp.linalg.solve(h, g)
        cases = [(newton_dir, 0.5, 0.5), (-40.0 * g, 0.5, 0.5),
                 (-g * 900.0, 0.3, 0.7), (g, 0.5, 0.5)]
        want = [float(jnewton.backtracking(val, x0, dd, g, c=c, gamma=gm))
                for dd, c, gm in cases]
    tg = torch.from_numpy(np.asarray(g))
    got = [tnewton.backtracking(pprob["val"], torch.zeros(d, dtype=torch.float64),
                                torch.from_numpy(np.asarray(dd)), tg, c=c,
                                gamma=gm) for dd, c, gm in cases]
    assert got == want
    assert want[0] == 1.0 and want[1] < 1.0 and want[-1] == 0.5**30


def test_quadratic_oracles_match_reference():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((4, 6, 6))
    q = a @ a.transpose(0, 2, 1)
    c = rng.standard_normal((4, 6))
    x = rng.standard_normal(6)
    with jax.enable_x64(True):
        jd = jobj.QuadData(jnp.asarray(q), jnp.asarray(c))
        jx = jnp.asarray(x)
        want = [np.asarray(f(jx, jd)) for f in
                (jobj.quad_value, jobj.quad_grad, jobj.quad_hess_batch)]
    td = tobj.QuadData(torch.from_numpy(q), torch.from_numpy(c))
    tx = torch.from_numpy(x)
    for f, w in zip((tobj.quad_value, tobj.quad_grad, tobj.quad_hess_batch),
                    want):
        np.testing.assert_allclose(f(tx, td).numpy(), w, rtol=1e-14,
                                   atol=1e-14)
