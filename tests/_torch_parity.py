"""Shared inputs for the port's parity tests: the reference's a1a data
as numpy arrays, the reference's own a1a oracles, and numpy inputs made
from a seed.

Importing this module changes no global state: every JAX computation
runs inside ``jax.enable_x64(True)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.objectives import batch_grad, batch_hess
from repro.data.synthetic import make_libsvm_like
from repro_torch.data import problem_from_data
from repro_torch.interop import logreg_from_numpy


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each port test on one intra-op thread and restore the count
    after it: the suite runs in several worker processes at once, and the
    a1a-sized tensors gain nothing from more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def jax_a1a_oracles() -> dict:
    """The reference's a1a data and oracles, as ``make_problem("a1a")``
    builds them (use the oracles inside ``jax.enable_x64(True)``)."""
    with jax.enable_x64(True):
        data = make_libsvm_like(jax.random.PRNGKey(0), "a1a", lam=1e-3)
    return dict(data=data, grad=lambda x: batch_grad(x, data),
                hess=lambda x: batch_hess(x, data),
                d=int(data.a.shape[-1]), n=int(data.a.shape[0]))


@functools.lru_cache(maxsize=None)
def reference_a1a() -> dict:
    """The reference's a1a data as numpy arrays."""
    prob = jax_a1a_oracles()
    data = prob["data"]
    return dict(a=np.asarray(data.a, np.float64),
                b=np.asarray(data.b, np.float64), lam=float(data.lam),
                d=prob["d"], n=prob["n"])


def reference_xstar() -> np.ndarray:
    """x* by the reference's own Newton run (25 rounds from 0)."""
    from repro.core.newton import newton_run

    prob = jax_a1a_oracles()
    with jax.enable_x64(True):
        xstar, _ = newton_run(jnp.zeros(prob["d"]), prob["grad"],
                              prob["hess"], 25)
        return np.asarray(xstar)


def port_problem(ref: dict) -> dict:
    """The port's oracle dict on the reference's a1a data, on the CPU."""
    return problem_from_data(logreg_from_numpy(ref["a"], ref["b"], ref["lam"],
                                               device="cpu"))


def stacked_diffs(n: int, d: int, seed: int, symmetric: bool = True):
    """(n, d, d) numpy Hessian-difference-like matrices from a seed."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d, d))
    return 0.5 * (m + m.transpose(0, 2, 1)) if symmetric else m
