"""FedNL Algorithm 1 in the port against the JAX reference, end to end
on the reference's own a1a data (n=16, m=100, d=123, f64).

Iterates are held round by round to 1e-8 absolute. Not tighter: the
two packages' eigh (Option 1's projection, Rank-R) and solve differ at
O(eps), and FedNL's transient from x0 = 0 amplifies that.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import jax_a1a_oracles, port_problem, reference_a1a
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.core.fednl import FedNL as JaxFedNL
from repro_torch.core import FedNL, make_compressor
from repro_torch.data import LIBSVM_SHAPES, make_problem
from repro_torch.engine import Oracles, available_methods, make_method
from repro_torch.interop import fednl_state_from_numpy

ROUNDS = 12
MU = 1e-3
CASES = [("topk", None), ("topk-sym", None), ("rankr", 1), ("blocktopk", 8)]


def _level(family, level, d):
    return d if level is None else level   # Top-K at k = d


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's FedNL iterates for every (compressor, option)."""
    out = {}
    prob = jax_a1a_oracles()
    with jax.enable_x64(True):
        d, n = prob["d"], prob["n"]
        x0 = jnp.zeros(d)
        for family, level in CASES:
            comp = jax_make_compressor(family, _level(family, level, d))
            for option in (1, 2):
                alg = JaxFedNL(prob["grad"], prob["hess"], comp,
                               option=option, mu=MU)
                _, xs = alg.run(x0, n, ROUNDS)
                out[family, option] = np.asarray(xs)
    return out


@pytest.mark.parametrize("option", [1, 2])
@pytest.mark.parametrize("family,level", CASES)
def test_fednl_iterates_match_reference(reference_runs, family, level,
                                        option):
    ref = reference_a1a()
    prob = port_problem(ref)
    comp = make_compressor(family, _level(family, level, ref["d"]))
    alg = FedNL(prob["grad"], prob["hess"], comp, option=option, mu=MU)
    x0 = torch.zeros(ref["d"], dtype=torch.float64)
    _, xs = alg.run(x0, ref["n"], ROUNDS)
    expect = reference_runs[family, option]
    assert xs.shape == expect.shape
    np.testing.assert_allclose(xs.numpy(), expect, rtol=0, atol=1e-8)
    # and the run converges: ||x - x*|| falls well below ||x0 - x*||
    err = np.linalg.norm((xs - prob["xstar"]).numpy(), axis=1)
    assert err[-1] < 0.25 * err[0]


def test_step_from_reference_state_matches_reference_step():
    """One step from the reference's own mid-run state (crossed over
    with ``fednl_state_from_numpy``) equals the reference's next state."""
    ref = reference_a1a()
    prob = jax_a1a_oracles()
    with jax.enable_x64(True):
        alg = JaxFedNL(prob["grad"], prob["hess"],
                       jax_make_compressor("topk-sym", ref["d"]), option=2)
        step = jax.jit(alg.step)
        s1 = step(step(alg.init(jnp.zeros(ref["d"]), ref["n"])))
        s2 = step(s1)
        s1_np = [np.asarray(v) for v in (s1.x, s1.h_local, s1.h_global,
                                         s1.step)]
        s2_np = [np.asarray(v) for v in (s2.x, s2.h_local, s2.h_global)]
    pprob = port_problem(ref)
    port = FedNL(pprob["grad"], pprob["hess"],
                 make_compressor("topk-sym", ref["d"]), option=2)
    t2 = port.step(fednl_state_from_numpy(*s1_np, device="cpu"))
    assert t2.step == int(s1_np[3]) + 1
    for got, want in zip((t2.x, t2.h_local, t2.h_global), s2_np):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_make_method_and_bits_match_reference():
    from repro.engine.method import Oracles as JaxOracles
    from repro.engine.method import make_method as jax_make_method

    d = LIBSVM_SHAPES["a1a"]["d"]
    for family, level in CASES:
        lvl = _level(family, level, d)
        port = make_method("fednl", Oracles(None, None, None),
                           make_compressor(family, lvl), option=2)
        with jax.enable_x64(True):
            ref = jax_make_method("fednl", JaxOracles(None, None, None),
                                  jax_make_compressor(family, lvl), option=2)
            want = ref.bits_per_round(d)
        assert port.bits_per_round(d) == want
        assert port.init_bits(d) == ref.init_bits(d)
    from repro.engine.method import available_methods as jax_available

    names = ["fednl", "fednl-bc", "fednl-cohort", "fednl-cr", "fednl-ls",
             "fednl-pp", "fednl-ppbc", "fednl-stoch", "n0", "n0-ls",
             "newton", "ns"]
    assert available_methods() == names
    assert names == sorted(jax_available())


def test_entry_points_default_to_cuda():
    """Without a card, an entry point the caller did not point at the
    CPU raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_problem("a1a")
    prob = make_problem("phishing", device="cpu")
    s = LIBSVM_SHAPES["phishing"]
    assert prob["data"].a.shape == (s["n"], s["m"], s["d"])
    assert prob["xstar"].dtype == torch.float64


def test_port_imports_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.data, "
            "repro_torch.engine, repro_torch.interop, repro_torch.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)
