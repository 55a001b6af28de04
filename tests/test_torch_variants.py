"""The FedNL variants in the port against the JAX reference on its own
a1a data (n=16, m=100, d=123, f64), with the reference's draws replayed
(``_torch_replay``): FedNL-PP, -CR, -LS, -BC, stochastic Hessians and
PP-BC, and Algorithm 1 with Rand-K.

Iterates are held round by round to 1e-8 absolute over 12 rounds, as
Algorithm 1's are (``test_torch_fednl.py``): the two packages' eigh and
solve differ at O(eps), and the transient from x0 = 0 amplifies that.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import jax_a1a_oracles, port_problem, reference_a1a
from _torch_replay import schedule, subsample_draws
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.core.objectives import global_value as jax_global_value
from repro.core.objectives import silo_hess as jax_silo_hess
from repro.engine.method import Oracles as JaxOracles
from repro.engine.method import available_methods as jax_available_methods
from repro.engine.method import make_method as jax_make_method
from repro_torch.core import (
    ExactHessian,
    SubsampledHessian,
    lipschitz_constants,
    make_compressor,
)
from repro_torch.core.objectives import batch_hess
from repro_torch.engine import Oracles, make_method
from repro_torch.engine.method import RoundDraws
from repro_torch.interop import (
    fednl_bc_state_from_numpy,
    fednl_pp_state_from_numpy,
    fednl_ppbc_state_from_numpy,
)

ROUNDS = 12
MU = 1e-3
TAU = 5
P = 0.5
M_SUB = 50
SEED = 3
HESS = [("topk", None), ("blocktopk", 8), ("rankr", 1)]
# (method, compressor family, level, option): Top-K, Block-Top-K 8 and
# Rank-R 1 under every variant, both options where the method has them
CASES = ([("fednl-pp", f, lv, None) for f, lv in HESS]
         + [("fednl-cr", f, lv, None) for f, lv in HESS]
         + [("fednl-ls", f, lv, None) for f, lv in HESS]
         + [("fednl-bc", f, lv, o) for f, lv in HESS for o in (1, 2)]
         + [("fednl-stoch", f, lv, None) for f, lv in HESS]
         + [("fednl-ppbc", f, lv, None) for f, lv in HESS]
         + [("fednl", "randk", None, o) for o in (1, 2)])


def _level(level, d):
    return d if level is None else level      # Top-K and Rand-K at k = d


def _params(method, family, level, option, d, l_star, make):
    """make_method's params for a case; ``make`` builds a compressor."""
    comp = make(family, _level(level, d))
    params = {}
    if method in ("fednl-pp", "fednl-ppbc"):
        params["tau"] = TAU
    if method in ("fednl-bc", "fednl-ppbc"):
        params["model_compressor"] = make("randk", d // 2)
    if method == "fednl-bc":
        params.update(p=P, option=option, mu=MU)
    if method == "fednl-cr":
        params["l_star"] = l_star
    if method == "fednl-ls":
        params["mu"] = MU
    if method == "fednl":
        params.update(option=option, mu=MU)
        if comp.spec((d, d)).omega is not None:
            params["alpha"] = 1.0 / (comp.spec((d, d)).omega + 1.0)
    return comp, params


def _jax_subsampled_hess(data):
    """tests/test_extensions.py's minibatch Hessian: M_SUB of m points."""
    n, m, _ = data.a.shape

    def hess(x, key):
        keys = jax.random.split(key, n)

        def one(a, b, k):
            idx = jax.random.choice(k, m, (M_SUB,), replace=False)
            return jax_silo_hess(x, a[idx], b[idx], data.lam)

        return jax.vmap(one)(data.a, data.b, keys)

    return hess


@contextlib.contextmanager
def _reference_block_kernel(d: int, k: int):
    """Route the reference's fused Block-Top-K uplink through its Pallas
    kernel (in interpret mode) instead of the sort-based oracle it runs
    off the TPU, by its own tuning cache, restored after. The port
    implements the kernel's selection: inside an f32 tie at the k-th
    magnitude it keeps entries in flat order, where the sort keeps the
    larger f64 value. Subsampled Hessians of a1a's binary features tie
    so; full ones do not."""
    from repro.kernels import tuning

    with jax.enable_x64(True):
        key = tuning.cache_key("diff_topk_payload", shape=(d, d), k=k,
                               n=128, dtype=jnp.float64)
    before = tuning.get_cache()
    cache = tuning.TuningCache()
    cache.put(key, tuning.KernelConfig(use_pallas=True))
    tuning.set_cache(cache)
    try:
        yield
    finally:
        tuning.set_cache(before)


@functools.lru_cache(maxsize=None)
def _reference(method, family, level, option):
    """The reference's iterates for one case."""
    prob = jax_a1a_oracles()
    data = prob["data"]
    d, n = prob["d"], prob["n"]
    l_star = lipschitz_constants(port_problem(reference_a1a())["data"])[
        "L_star"]
    with jax.enable_x64(True):
        oracles = JaxOracles(lambda x: jax_global_value(x, data),
                             prob["grad"], prob["hess"])
        comp, params = _params(method, family, level, option, d, l_star,
                               jax_make_compressor)
        alg_kernel = contextlib.nullcontext()
        if method == "fednl-stoch":
            params["hess_fn_stoch"] = _jax_subsampled_hess(data)
            if family == "blocktopk":
                alg_kernel = _reference_block_kernel(d, level)
        alg = jax_make_method(method, oracles, comp, **params)
        with alg_kernel:
            _, xs = alg.run(jnp.zeros(d), n, ROUNDS, seed=SEED)
        return np.asarray(xs)


def _port_run(method, family, level, option, draws):
    ref = reference_a1a()
    prob = port_problem(ref)
    d, n = ref["d"], ref["n"]
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    l_star = lipschitz_constants(prob["data"])["L_star"]
    comp, params = _params(method, family, level, option, d, l_star,
                           make_compressor)
    if method == "fednl-stoch":
        params["hess_fn_stoch"] = SubsampledHessian(prob["data"], M_SUB)
    alg = make_method(method, oracles, comp, **params)
    _, xs = alg.run(torch.zeros(d, dtype=torch.float64), n, ROUNDS,
                    draws=draws)
    return alg, xs, prob


def _replay(method, family, level, option, key=SEED, rounds=ROUNDS,
            init=True):
    ref = reference_a1a()
    d, n = ref["d"], ref["n"]
    comp, params = _params(method, family, level, option, d, 0.0,
                           make_compressor)
    return schedule(method, key, rounds, n, d, comp=comp,
                    comp_m=params.get("model_compressor"),
                    tau=params.get("tau"), p=params.get("p"),
                    m=ref["a"].shape[1], m_sub=M_SUB, init=init)


@pytest.mark.parametrize("method,family,level,option", CASES)
def test_variant_iterates_match_reference(method, family, level, option):
    draws = _replay(method, family, level, option)
    alg, xs, prob = _port_run(method, family, level, option, draws)
    assert draws.left() == 0, "the port took fewer draws than the reference"
    expect = _reference(method, family, level, option)
    assert xs.shape == expect.shape
    np.testing.assert_allclose(xs.numpy(), expect, rtol=0, atol=1e-8)
    assert bool(torch.isfinite(xs).all())


def test_variants_bits_match_reference():
    """bits_per_round of every variant and compressor family equals the
    reference's (its wire_cost(...).analytic_bits)."""
    d = reference_a1a()["d"]
    families = HESS + [("randk", None), ("powersgd", 1), ("topk-sym", None),
                       ("natural", 0.25), ("dithering", 4)]
    methods = ["fednl", "fednl-pp", "fednl-cr", "fednl-ls", "fednl-bc",
               "fednl-stoch", "fednl-ppbc"]
    for method in methods:
        for family, level in families:
            args = (method, family, level, 1, d, 1.0)
            comp, params = _params(*args, make_compressor)
            port = make_method(method, Oracles(None, None, None), comp,
                               **params)
            with jax.enable_x64(True):
                comp, params = _params(*args, jax_make_compressor)
                ref = jax_make_method(method, JaxOracles(None, None, None),
                                      comp, **params)
                want = ref.bits_per_round(d)
            assert port.bits_per_round(d) == want, (method, family)


def test_registry_has_every_reference_method_but_the_cohort():
    from repro_torch.engine import available_methods

    # the cohort is in since the engine slice: the whole registry
    assert available_methods() == sorted(jax_available_methods())


def _reference_states(method, comp_family, level, option):
    """The reference's state after 2 and 3 rounds (jitted steps)."""
    prob = jax_a1a_oracles()
    d, n = prob["d"], prob["n"]
    with jax.enable_x64(True):
        comp, params = _params(method, comp_family, level, option, d, 0.0,
                               jax_make_compressor)
        alg = jax_make_method(method, JaxOracles(None, prob["grad"],
                                                 prob["hess"]),
                              comp, **params)
        step = jax.jit(alg.step)
        s1 = step(step(alg.init(jnp.zeros(d), n, seed=SEED)))
        s2 = step(s1)
    as_np = lambda s: {f: np.asarray(v) for f, v in s._asdict().items()}
    return as_np(s1), as_np(s2), s1.key


@pytest.mark.parametrize("method,convert", [
    ("fednl-pp", fednl_pp_state_from_numpy),
    ("fednl-bc", fednl_bc_state_from_numpy),
    ("fednl-ppbc", fednl_ppbc_state_from_numpy)])
def test_step_from_reference_state_matches_reference_step(method, convert):
    """One step from the reference's own mid-run state, crossed over,
    with the draws of that step replayed, equals the reference's next
    state."""
    ref = reference_a1a()
    prob = port_problem(ref)
    s1, s2, key = _reference_states(method, "topk", None, 1)
    draws = _replay(method, "topk", None, 1, key=key, rounds=1, init=False)
    fields = {f: v for f, v in s1.items() if f != "key"}
    state = convert(**fields, device="cpu", draws=draws)
    comp, params = _params(method, "topk", None, 1, ref["d"], 0.0,
                           make_compressor)
    alg = make_method(method, Oracles(None, prob["grad"], prob["hess"]),
                      comp, **params)
    t2 = alg.step(state)
    assert draws.left() == 0
    assert t2.step == int(s1["step"]) + 1
    for field, want in s2.items():
        if field in ("key", "step"):
            continue
        got = getattr(t2, field)
        if isinstance(got, bool):
            assert got == bool(want), field
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10,
                                       err_msg=field)


def test_subsample_oracle_matches_reference():
    """The port's ``SubsampledHessian`` on the reference's points: the
    same subsampled Hessians (what the stochastic cases rest on)."""
    prob = jax_a1a_oracles()
    ref = reference_a1a()
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(True):
        x = jnp.linspace(-0.1, 0.1, ref["d"])
        want = np.asarray(_jax_subsampled_hess(prob["data"])(x, key))
    idx = subsample_draws(key, ref["n"], ref["a"].shape[1], M_SUB)
    got = SubsampledHessian(port_problem(ref)["data"], M_SUB)(
        torch.from_numpy(np.array(x)), idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


def test_round_draws_hand_each_oracle_its_draw():
    """The default round-draw source hands ``SubsampledHessian`` its
    points from the source's CPU generator (M_SUB distinct of m a silo,
    the same for one seed) and ``ExactHessian`` nothing."""
    data = port_problem(reference_a1a())["data"]
    n, m = data.a.shape[:2]
    oracle = SubsampledHessian(data, M_SUB)
    first, again = (RoundDraws(7).oracle(oracle) for _ in range(2))
    assert first.shape == (n, M_SUB) and torch.equal(first, again)
    srt = torch.sort(first, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all()) and int(srt.max()) < m
    exact = ExactHessian(lambda x: batch_hess(x, data))
    assert RoundDraws(7).oracle(exact) is None
    x = torch.zeros(data.a.shape[2], dtype=torch.float64)
    assert torch.equal(exact(x, None), batch_hess(x, data))


def test_port_script_and_tools_import_no_jax_or_reference():
    """No module of the port, ``chip_smoke.py`` or ``tools/`` imports
    JAX or the JAX package, at any depth of the file."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = ([root / "chip_smoke.py"] + sorted((root / "tools").glob("*.py"))
             + sorted((root / "src" / "repro_torch").rglob("*.py")))
    assert len(files) > 40
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {name}" for name in names
                    if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
