"""The Newton family (N, N0, NS, N0-LS) and the paper's baselines (GD,
GD-LS, DIANA, ADIANA, DINGO, NL1, DORE, Artemis) in the port against
the JAX reference on its a1a data (f64), with the reference's draws
replayed (``_torch_replay``). Iterates are held round by round to 1e-8
absolute over 12 rounds, as FedNL's are; ``bits_per_round`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import jax_a1a_oracles, port_problem, reference_a1a
from _torch_replay import schedule
from repro.core import baselines as jb
from repro.core import compressors as jc
from repro.core.objectives import global_value as jax_global_value
from repro.engine.method import Oracles as JaxOracles
from repro.engine.method import make_method as jax_make_method
from repro_torch.core import baselines as tb
from repro_torch.core import compressors as tc
from repro_torch.core import lipschitz_constants
from repro_torch.engine import Oracles, make_method

ROUNDS = 12
SEED = 5
TAU = 4
NEWTON = [("newton", {}), ("n0", {}), ("n0", {"mu": 1e-3}), ("ns", {}),
          ("n0-ls", {"mu": 1e-3})]
# (baseline, uplink compressor, downlink compressor)
BASELINES = [("diana", ("randk", 30), None),
             ("diana", ("dithering", 4), None),
             ("adiana", ("randk", 30), None),
             ("dore", ("randk", 30), ("dithering", 8)),
             ("artemis", ("randk", 30), None),
             ("artemis", ("natural", 0.25), None),
             ("nl1", None, None), ("dingo", None, None), ("gd", None, None),
             ("gd-ls", None, None)]


@functools.lru_cache(maxsize=None)
def _problems():
    ref = reference_a1a()
    prob = port_problem(ref)
    jprob = jax_a1a_oracles()
    consts = lipschitz_constants(prob["data"])
    with jax.enable_x64(True):
        hstar = jnp.mean(jprob["hess"](jnp.asarray(prob["xstar"].numpy())),
                         axis=0)
    return ref, prob, jprob, consts, np.array(hstar)


def _newton_params(name, params, hstar, to_array):
    params = dict(params)
    if name == "ns":
        params["h_fixed"] = to_array(hstar)
    return params


@pytest.mark.parametrize("name,params", NEWTON)
def test_newton_family_matches_reference(name, params):
    ref, prob, jprob, _, hstar = _problems()
    d, n = ref["d"], ref["n"]
    with jax.enable_x64(True):
        data = jprob["data"]
        oracles = JaxOracles(lambda x: jax_global_value(x, data),
                             jprob["grad"], jprob["hess"])
        alg = jax_make_method(name, oracles,
                              **_newton_params(name, params, hstar,
                                               jnp.asarray))
        _, want = alg.run(jnp.zeros(d), n, ROUNDS)
        want_bits = alg.bits_per_round(d)
    port = make_method(name, Oracles(prob["val"], prob["grad"], prob["hess"]),
                       **_newton_params(name, params, hstar, torch.from_numpy))
    _, xs = port.run(torch.zeros(d, dtype=torch.float64), n, ROUNDS)
    np.testing.assert_allclose(xs.numpy(), np.asarray(want), rtol=0,
                               atol=1e-8)
    assert port.bits_per_round(d) == want_bits


def _build(lib, name, up, down, prob, consts, d, n):
    """The baseline ``name`` from package ``lib`` (the reference's
    baselines module and compressors, or the port's)."""
    base, comps, grad = lib
    cu = None if up is None else comps.make_compressor(*up)
    cd = None if down is None else comps.make_compressor(*down)
    om = None if cu is None else cu.spec((d,)).omega
    smooth = consts["L"]
    if name == "diana":
        return base.Diana(grad, cu, smooth, n, om)
    if name == "adiana":
        return base.Adiana(grad, cu, smooth, consts["mu"], n, om)
    if name == "dore":
        return base.Dore(grad, cu, cd, smooth, n, om, cd.spec((d,)).omega)
    if name == "artemis":
        return base.Artemis(grad, cu, smooth, n, om, TAU)
    if name == "nl1":
        return base.NL1(prob["data"], k=3)
    return base.Dingo(prob["val"], grad, prob["hess"])


def _reference_run(name, up, down):
    ref, _, jprob, consts, _ = _problems()
    d, n = ref["d"], ref["n"]
    with jax.enable_x64(True):
        data = jprob["data"]
        val = lambda x: jax_global_value(x, data)
        x0 = jnp.zeros(d)
        if name == "gd":
            return np.asarray(jb.gd_run(x0, jprob["grad"], 1.0 / consts["L"],
                                        ROUNDS)[1]), jb.gd_bits_per_round(d)
        if name == "gd-ls":
            return np.asarray(jb.gd_ls_run(x0, val, jprob["grad"],
                                           ROUNDS)[1]), None
        prob = dict(jprob, val=val)
        alg = _build((jb, jc, jprob["grad"]), name, up, down, prob, consts,
                     d, n)
        if name == "dingo":
            xs = alg.run(x0, ROUNDS)[1]
        elif name == "nl1":
            xs = alg.run(x0, ROUNDS, seed=SEED)[1]
        else:
            xs = alg.run(x0, n, ROUNDS, seed=SEED)[1]
        return np.asarray(xs), alg.bits_per_round(d)


@pytest.mark.parametrize("name,up,down", BASELINES)
def test_baseline_matches_reference(name, up, down):
    ref, prob, _, consts, _ = _problems()
    d, n = ref["d"], ref["n"]
    want, want_bits = _reference_run(name, up, down)
    x0 = torch.zeros(d, dtype=torch.float64)
    if name == "gd":
        xs = tb.gd_run(x0, prob["grad"], 1.0 / consts["L"], ROUNDS)[1]
        assert tb.gd_bits_per_round(d) == want_bits
    elif name == "gd-ls":
        xs = tb.gd_ls_run(x0, prob["val"], prob["grad"], ROUNDS)[1]
    else:
        alg = _build((tb, tc, prob["grad"]), name, up, down, prob, consts,
                     d, n)
        if name == "dingo":
            xs = alg.run(x0, ROUNDS)[1]
        else:
            draws = schedule(
                name, SEED, ROUNDS, n, d,
                comp=getattr(alg, "comp", getattr(alg, "comp_up", None)),
                comp_m=getattr(alg, "comp_down", None), tau=TAU,
                p=getattr(alg, "p", None), m=ref["a"].shape[1], k=3)
            if name == "nl1":
                xs = alg.run(x0, ROUNDS, draws=draws)[1]
            else:
                xs = alg.run(x0, n, ROUNDS, draws=draws)[1]
            assert draws.left() == 0
        assert alg.bits_per_round(d) == want_bits
    np.testing.assert_allclose(xs.numpy(), want, rtol=0, atol=1e-8)
    assert bool(torch.isfinite(xs).all())
