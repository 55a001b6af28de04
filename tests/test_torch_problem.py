"""The port's problem layer and Newton-step linear algebra against the
JAX reference, on the reference's own a1a ``LogRegData`` (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import port_problem, reference_a1a, reference_xstar, stacked_diffs
from repro.core import linalg as jlinalg
from repro.core import objectives as jobj
from repro_torch.core import linalg as tlinalg
from repro_torch.core import objectives as tobj
from repro_torch.core.newton import newton_run, newton_step
from repro_torch.data import LIBSVM_SHAPES, make_libsvm_like
from repro_torch.interop import logreg_from_numpy


@pytest.fixture(scope="module")
def a1a():
    ref = reference_a1a()
    x = np.random.default_rng(30).standard_normal(ref["d"]) * 0.3
    return ref, x


def _jax_data(ref):
    return jobj.LogRegData(a=jnp.asarray(ref["a"]), b=jnp.asarray(ref["b"]),
                           lam=ref["lam"])


@pytest.mark.parametrize("oracle", ["value", "grad", "hess"])
def test_silo_oracles_match_reference(a1a, oracle):
    ref, x = a1a
    data = logreg_from_numpy(ref["a"], ref["b"], ref["lam"], device="cpu")
    xt = torch.from_numpy(x)
    with jax.enable_x64(True):
        jdata = _jax_data(ref)
        want_batch = np.asarray(getattr(jobj, f"batch_{oracle}")(
            jnp.asarray(x), jdata))
        want_silo = np.asarray(getattr(jobj, f"silo_{oracle}")(
            jnp.asarray(x), jdata.a[3], jdata.b[3], ref["lam"]))
    got_batch = getattr(tobj, f"batch_{oracle}")(xt, data)
    got_silo = getattr(tobj, f"silo_{oracle}")(xt, data.a[3], data.b[3],
                                               ref["lam"])
    np.testing.assert_allclose(got_batch.numpy(), want_batch, rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(got_silo.numpy(), want_silo, rtol=1e-12,
                               atol=1e-15)


def test_global_oracles_and_constants_match_reference(a1a):
    ref, x = a1a
    data = logreg_from_numpy(ref["a"], ref["b"], ref["lam"], device="cpu")
    xt = torch.from_numpy(x)
    with jax.enable_x64(True):
        jdata = _jax_data(ref)
        for name in ("global_value", "global_grad", "global_hess"):
            want = np.asarray(getattr(jobj, name)(jnp.asarray(x), jdata))
            got = getattr(tobj, name)(xt, data)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-15)
        want_c = jobj.lipschitz_constants(jdata)
    got_c = tobj.lipschitz_constants(data)
    assert got_c.keys() == want_c.keys()
    for key in want_c:
        assert got_c[key] == pytest.approx(want_c[key], rel=1e-12)


def test_newton_xstar_matches_reference(a1a):
    ref, _ = a1a
    prob = port_problem(ref)
    np.testing.assert_allclose(prob["xstar"].numpy(), reference_xstar(),
                               rtol=0, atol=1e-10)
    g = torch.mean(prob["grad"](prob["xstar"]), dim=0)
    assert float(torch.linalg.vector_norm(g)) < 1e-12
    x1 = newton_step(torch.zeros(ref["d"], dtype=torch.float64),
                     prob["grad"], prob["hess"])
    _, xs = newton_run(torch.zeros(ref["d"], dtype=torch.float64),
                       prob["grad"], prob["hess"], 2)
    assert xs.shape == (3, ref["d"]) and torch.equal(xs[1], x1)


@pytest.mark.parametrize("mu", [0.0, 0.5])
def test_project_psd_matches_reference(mu):
    m = stacked_diffs(3, 30, seed=31, symmetric=False)
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jlinalg.project_psd(jnp.asarray(mi), mu))
                         for mi in m])
    got = tlinalg.project_psd(torch.from_numpy(m), mu)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    evals = torch.linalg.eigvalsh(got)
    assert float(evals.min()) >= mu - 1e-12


def test_solve_frob_symmetrize_match_reference():
    rng = np.random.default_rng(32)
    m = stacked_diffs(1, 30, seed=33)[0] + 30 * np.eye(30)
    g = rng.standard_normal(30)
    with jax.enable_x64(True):
        want_x = np.asarray(jlinalg.solve_newton_system(jnp.asarray(m),
                                                        jnp.asarray(g)))
        want_f = float(jlinalg.frob_norm(jnp.asarray(m)))
        want_s = np.asarray(jlinalg.symmetrize(jnp.asarray(m + np.triu(m))))
    mt = torch.from_numpy(m)
    np.testing.assert_allclose(
        tlinalg.solve_newton_system(mt, torch.from_numpy(g)).numpy(), want_x,
        rtol=1e-12, atol=0)
    assert float(tlinalg.frob_norm(mt)) == pytest.approx(want_f, rel=1e-14)
    np.testing.assert_allclose(
        tlinalg.symmetrize(torch.from_numpy(m + np.triu(m))).numpy(), want_s,
        rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", sorted(LIBSVM_SHAPES))
def test_libsvm_like_shapes_and_recipe(name):
    """Same shapes as the reference's Table 3 stand-ins; draws differ."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    data = make_libsvm_like(gen, name)
    s = LIBSVM_SHAPES[name]
    assert data.a.shape == (s["n"], s["m"], s["d"])
    assert data.b.shape == (s["n"], s["m"])
    assert data.a.dtype == torch.float64 and data.lam == 1e-3
    assert set(torch.unique(data.a).tolist()) <= {0.0, 1.0}
    assert set(torch.unique(data.b).tolist()) <= {-1.0, 1.0}
    assert abs(float(data.a.mean()) - 0.15) < 0.01
    again = make_libsvm_like(torch.Generator().manual_seed(0), name)
    assert torch.equal(again.a, data.a) and torch.equal(again.b, data.b)
