"""The convergence checks of ``tests/test_fednl_convergence.py`` (linear
and superlinear rates, Hessian learning, PP, LS, CR, BC, Rand-K, the
Newton triangle), run on the port, f64, with the port's own draws.

The problem is the reference file's: ``make_synthetic`` (alpha = beta =
0.5, n=8, m=60, d=16, lam=1e-3), its arrays crossed over as numpy.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.data.synthetic import make_synthetic
from repro_torch.core import (
    FedNL,
    FedNLBC,
    FedNLCR,
    FedNLLS,
    FedNLPP,
    RandK,
    RankR,
    TopK,
    Zero,
    batch_grad,
    batch_hess,
    global_value,
    lipschitz_constants,
)
from repro_torch.core.newton import fixed_hessian_run, newton_run
from repro_torch.interop import logreg_from_numpy

N = 8


@functools.lru_cache(maxsize=None)
def _problem():
    with jax.enable_x64(True):
        data = make_synthetic(jax.random.PRNGKey(0), alpha=0.5, beta=0.5,
                              n=N, m=60, d=16, lam=1e-3)
        a, b = np.asarray(data.a, np.float64), np.asarray(data.b, np.float64)
    data = logreg_from_numpy(a, b, 1e-3, device="cpu")
    grad_fn = lambda x: batch_grad(x, data)
    hess_fn = lambda x: batch_hess(x, data)
    val_fn = lambda x: global_value(x, data)
    xstar, _ = newton_run(torch.zeros(16, dtype=torch.float64), grad_fn,
                          hess_fn, 50)
    return dict(data=data, grad=grad_fn, hess=hess_fn, val=val_fn,
                xstar=xstar, consts=lipschitz_constants(data))


def _x0_near(prob, scale=1e-2, seed=3):
    rng = np.random.default_rng(seed)
    return prob["xstar"] + scale * torch.from_numpy(rng.standard_normal(16))


def _gap(prob, x) -> float:
    return float(prob["val"](x) - prob["val"](prob["xstar"]))


def _sq_err(prob, xs):
    return torch.sum((xs - prob["xstar"]) ** 2, dim=-1)


def test_fednl_linear_rate_eq6():
    """(6): ||x^k - x*||^2 <= (1/2^k) ||x^0 - x*||^2 locally."""
    prob = _problem()
    alg = FedNL(prob["grad"], prob["hess"], RankR(1), alpha=1.0, option=1,
                mu=1e-3)
    _, xs = alg.run(_x0_near(prob), N, 18)
    r = _sq_err(prob, xs)
    for k in range(1, 15):
        assert float(r[k]) <= float(r[0]) / 2**k * 4 + 1e-24, k


def test_fednl_superlinear_ratio_decreases():
    """(8): r_{k+1} / r_k -> 0."""
    prob = _problem()
    alg = FedNL(prob["grad"], prob["hess"], RankR(2), alpha=1.0, option=1,
                mu=1e-3)
    _, xs = alg.run(_x0_near(prob, scale=5e-2), N, 14)
    r = _sq_err(prob, xs)
    ratios = [float(r[k + 1] / r[k]) for k in range(10) if r[k] > 1e-28]
    assert ratios[-1] < 0.2 * ratios[0] + 1e-12


def test_fednl_hessian_learning():
    """Phi^k decays linearly (7): H_i^k -> hess_i(x*)."""
    prob = _problem()
    alg = FedNL(prob["grad"], prob["hess"], TopK(k=64), alpha=1.0, option=2)
    state = alg.init(_x0_near(prob), N)
    hstar = prob["hess"](prob["xstar"])
    errs = [float(torch.mean(torch.sum((state.h_local - hstar) ** 2,
                                       dim=(-2, -1))))]
    for _ in range(25):
        state = alg.step(state)
        errs.append(float(torch.mean(torch.sum((state.h_local - hstar) ** 2,
                                               dim=(-2, -1)))))
    assert errs[-1] < 1e-3 * errs[0]


def test_fednl_option2_converges():
    prob = _problem()
    alg = FedNL(prob["grad"], prob["hess"], RankR(1), alpha=1.0, option=2)
    final, _ = alg.run(_x0_near(prob), N, 25)
    assert _gap(prob, final.x) < 1e-16


@pytest.mark.parametrize("seed", [0, 1])
def test_fednl_unbiased_randk(seed):
    prob = _problem()
    comp = RandK(k=64)
    omega = comp.spec((16, 16)).omega
    alg = FedNL(prob["grad"], prob["hess"], comp, alpha=1.0 / (1.0 + omega),
                option=1, mu=1e-3)
    final, _ = alg.run(_x0_near(prob), N, 60, seed=seed)
    assert _gap(prob, final.x) < 1e-14


def test_n0_linear_ns_quadratic():
    prob = _problem()
    x0 = _x0_near(prob, scale=5e-2)
    h0 = torch.mean(prob["hess"](x0), dim=0)
    _, xs = fixed_hessian_run(x0, h0, prob["grad"], 15)
    r = torch.linalg.vector_norm(xs - prob["xstar"], dim=-1) ** 2
    assert float(r[10]) <= float(r[0]) / 2**10 * 16  # N0: 1/2^k, slack

    hstar = torch.mean(prob["hess"](prob["xstar"]), dim=0)
    _, xs = fixed_hessian_run(x0, hstar, prob["grad"], 6)
    rr = torch.linalg.vector_norm(xs - prob["xstar"], dim=-1)
    c = prob["consts"]["L_star"] / (2 * 1e-3)      # NS: r+ <= C r^2
    for k in range(3):
        if rr[k] > 1e-14:
            assert float(rr[k + 1]) <= c * float(rr[k]) ** 2 * 10


@pytest.mark.parametrize("seed", [0, 1])
def test_fednl_pp_converges(seed):
    prob = _problem()
    alg = FedNLPP(prob["grad"], prob["hess"], RankR(1), tau=3)
    final, _ = alg.run(_x0_near(prob), N, 60, seed=seed)
    assert _gap(prob, final.x) < 1e-14


def test_fednl_ls_global():
    prob = _problem()
    alg = FedNLLS(prob["val"], prob["grad"], prob["hess"], RankR(1), mu=1e-3)
    _, xs = alg.run(torch.full((16,), 3.0, dtype=torch.float64), N, 40)
    vals = [float(prob["val"](x)) for x in xs]
    assert all(vals[i + 1] <= vals[i] + 1e-12 for i in range(len(vals) - 1)), \
        "line search must be monotone"
    assert vals[-1] - float(prob["val"](prob["xstar"])) < 1e-12


def test_fednl_cr_global():
    prob = _problem()
    alg = FedNLCR(prob["grad"], prob["hess"], RankR(1),
                  l_star=prob["consts"]["L_star"])
    _, xs = alg.run(torch.full((16,), 2.0, dtype=torch.float64), N, 150)
    vals = [float(prob["val"](x)) for x in xs]
    fstar = float(prob["val"](prob["xstar"]))
    assert all(vals[i + 1] <= vals[i] + 1e-10 for i in range(len(vals) - 1)), \
        "the cubic model step must decrease f"
    assert vals[-1] - fstar < 0.5 * (vals[0] - fstar)


@pytest.mark.parametrize("seed", [0, 1])
def test_fednl_bc_converges(seed):
    prob = _problem()
    d = 16
    alg = FedNLBC(prob["grad"], prob["hess"], TopK(k=int(0.9 * d * d)),
                  TopK(k=d), p=0.9, option=1, mu=1e-3)
    final, _ = alg.run(_x0_near(prob), N, 80, seed=seed)
    assert _gap(prob, final.z) < 1e-12


def test_newton_triangle_specializations():
    """FedNL with C = 0, alpha = 0, H_i^0 = hess_i(x0) IS Newton-Zero."""
    prob = _problem()
    x0 = _x0_near(prob)
    alg = FedNL(prob["grad"], prob["hess"], Zero(), alpha=0.0, option=1,
                mu=1e-3)
    _, xs_fednl = alg.run(x0, N, 8)
    h0 = torch.mean(prob["hess"](x0), dim=0)
    _, xs_n0 = fixed_hessian_run(x0, h0, prob["grad"], 8, mu=1e-3)
    np.testing.assert_allclose(xs_fednl.numpy(), xs_n0.numpy(), atol=1e-10)
