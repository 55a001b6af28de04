"""The port's experiment engine (``repro_torch.engine``: the sweep, its
records and their wire accounting, the sweep CLI) and its data modules
against the JAX reference.

On the reference's a1a data, with a shared x0 and the reference's draws
replayed (``_torch_replay``), an 8-round port ``Sweep`` agrees with the
reference's ``Sweep`` to 1e-8 (iterates and gaps: the two packages'
eigh and solve differ at O(eps)); records and summaries carry the same
keys in the same order; and the four accounting columns (``bits``,
``bits_measured``, ``bits_entropy``, ``seconds_per_round``) equal the
reference's exactly, for every registered method. A port sweep equals
the port's serial runs bit for bit.

Every JAX computation runs inside ``jax.enable_x64(True)``.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import port_problem, reference_a1a
from _torch_replay import schedule
from repro.core.cohort import CohortSpec as JaxCohortSpec
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.data import libsvm as jax_libsvm
from repro.data import synthetic as jax_synthetic
from repro.data.problems import make_problem as jax_make_problem
from repro.engine import ExperimentSpec as JaxSpec
from repro.engine import Sweep as JaxSweep
from repro.engine import records as jax_rec
from repro.engine.method import Oracles as JaxOracles
from repro.engine.method import available_methods as jax_available_methods
from repro.engine.method import make_method as jax_make_method
from repro.launch import sweep as jax_cli
from repro_torch.core import CohortSpec, make_compressor
from repro_torch.data import libsvm, synthetic
from repro_torch.data.problems import make_problem
from repro_torch.engine import (
    ExperimentSpec,
    Oracles,
    Sweep,
    available_methods,
    build_compressor,
    make_method,
    run_sweep,
)
from repro_torch.engine import records as rec
from repro_torch.launch import sweep as cli

ROUNDS = 8
MU = 1e-3
TAU = 5
SRC = Path(__file__).resolve().parents[1] / "src"


@functools.lru_cache(maxsize=None)
def jax_problem() -> dict:
    """The reference's a1a problem dict (its ``make_problem``)."""
    with jax.enable_x64(True):
        return jax_make_problem("a1a")


@functools.lru_cache(maxsize=None)
def torch_problem() -> dict:
    """The port's problem dict on the same data (CPU)."""
    return port_problem(reference_a1a())


def shared_x0() -> np.ndarray:
    """0.05 N(0, I) from a numpy seed, handed to both packages."""
    return 0.05 * np.random.default_rng(1).standard_normal(123)


# (label, method, compressor family, level, params): one cell each
CELLS = [
    ("topk-o1", "fednl", "topk", 123, dict(option=1, mu=MU)),
    ("topk-o2", "fednl", "topk", 123, dict(option=2)),
    ("blocktopk-o1", "fednl", "blocktopk", 8, dict(option=1, mu=MU)),
    ("blocktopk-o2", "fednl", "blocktopk", 8, dict(option=2)),
    ("rankr-o1", "fednl", "rankr", 1, dict(option=1, mu=MU)),
    ("rankr-o2", "fednl", "rankr", 1, dict(option=2)),
    ("bc", "fednl-bc", "topk", 123,
     dict(model_compressor=("randk", 61), p=0.5, option=1, mu=MU)),
    ("pp", "fednl-pp", "topk", 123, dict(tau=TAU)),
    ("newton", "newton", None, None, {}),
]


def _draws(spec, seed):
    """The reference's draws of ``spec``'s seed, replayed."""
    if spec.method == "newton":
        return None
    prob = torch_problem()
    n, d = prob["n"], prob["d"]
    comp = build_compressor(spec.compressor, spec.level)
    kw = {}
    if spec.method == "fednl-pp":
        kw["tau"] = spec.params["tau"]
    if spec.method == "fednl-bc":
        kw.update(comp_m=make_compressor(*spec.params["model_compressor"]),
                  p=spec.params["p"])
    return schedule(spec.method, seed, spec.num_rounds, n, d, comp=comp, **kw)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_sweep_matches_reference(cell):
    name, method, family, level, params = cell
    seeds = (0, 1) if method == "fednl" else (0,)
    x0 = shared_x0()
    spec = ExperimentSpec(method, family, level, params=params, seeds=seeds,
                          num_rounds=ROUNDS)
    with jax.enable_x64(True):
        jspec = JaxSpec(method, family, level, params=dict(params),
                        seeds=seeds, num_rounds=ROUNDS)
        want = JaxSweep([jspec]).run(jax_problem(), x0=jnp.asarray(x0))
        want_rows = want.records()
        want_summary = want.summary(target=1e-6)
    got = Sweep([spec]).run(torch_problem(), x0=torch.from_numpy(x0),
                            draws=_draws)
    g, w = got.cells[0], want.cells[0]
    assert g.xs.shape == w.xs.shape == (len(seeds), ROUNDS + 1, 123)
    np.testing.assert_allclose(g.xs, w.xs, rtol=0, atol=1e-8)
    np.testing.assert_allclose(g.gaps, w.gaps, rtol=0, atol=1e-8)
    for col in ("bits", "bits_measured", "bits_entropy"):
        np.testing.assert_array_equal(getattr(g, col), getattr(w, col))
    assert g.seconds_per_round == w.seconds_per_round
    rows = got.records()
    assert [list(r) for r in rows] == [list(r) for r in want_rows]
    for r, wr in zip(rows, want_rows):
        for key in ("name", "method", "compressor", "level", "seed", "round",
                    "bits", "bits_measured", "bits_entropy",
                    "seconds_per_round"):
            assert r[key] == wr[key], key
    summary = got.summary(target=1e-6)
    assert [list(r) for r in summary] == [list(r) for r in want_summary]
    for key in ("bits_per_round", "bits_per_round_measured",
                "bits_per_round_entropy", "seconds_per_round", "num_seeds"):
        assert summary[0][key] == want_summary[0][key], key


def _methods(oracles, make, cohort_cls, d, family, level):
    """Every registered method's build at (family, level), the same in
    both packages; ``make`` builds a compressor."""
    comp = make(family, level)
    down = make("randk", d // 2)
    hess0 = np.eye(d)
    return {
        "fednl": lambda m: m("fednl", oracles, comp, option=2),
        "fednl-pp": lambda m: m("fednl-pp", oracles, comp, tau=TAU),
        "fednl-cr": lambda m: m("fednl-cr", oracles, comp, l_star=1.0),
        "fednl-ls": lambda m: m("fednl-ls", oracles, comp, mu=MU),
        "fednl-bc": lambda m: m("fednl-bc", oracles, comp,
                                model_compressor=down, p=0.5),
        "fednl-stoch": lambda m: m("fednl-stoch", oracles, comp),
        "fednl-ppbc": lambda m: m("fednl-ppbc", oracles, comp,
                                  model_compressor=down, tau=TAU),
        "fednl-cohort": lambda m: m("fednl-cohort", oracles, comp,
                                    cohort=cohort_cls(cohort=TAU)),
        "newton": lambda m: m("newton", oracles),
        "n0": lambda m: m("n0", oracles),
        "ns": lambda m: m("ns", oracles, h_fixed=hess0),
        "n0-ls": lambda m: m("n0-ls", oracles),
    }


def test_registries_match():
    assert available_methods() == jax_available_methods()
    assert "fednl-cohort" in available_methods()


@pytest.mark.parametrize("family,level", [("topk", 40), ("blocktopk", 8),
                                          ("rankr", 2), ("randk", 40),
                                          ("topk-sym", 40)])
@pytest.mark.parametrize("name", sorted(jax_available_methods()))
def test_accounting_columns_equal_reference(name, family, level):
    """bits, bits_measured, bits_entropy and seconds_per_round of every
    registered method, exactly the reference's (d = 123, n = 16)."""
    d, n = 123, 16
    f = lambda x: x
    port = _methods(Oracles(f, f, f), make_compressor, CohortSpec, d,
                    family, level)[name](make_method)
    with jax.enable_x64(True):
        ref = _methods(JaxOracles(f, f, f), jax_make_compressor,
                       JaxCohortSpec, d, family, level)[name](jax_make_method)
        want = (jax_rec.bits_curve(ref, d, 5),
                jax_rec.measured_bits_curve(ref, d, 5),
                jax_rec.entropy_bits_curve(ref, d, 5),
                jax_rec.seconds_per_round(ref, d, n, link="wan"),
                jax_rec.seconds_curve(ref, d, n, 5, link="datacenter"))
    got = (rec.bits_curve(port, d, 5), rec.measured_bits_curve(port, d, 5),
           rec.entropy_bits_curve(port, d, 5),
           rec.seconds_per_round(port, d, n, link="wan"),
           rec.seconds_curve(port, d, n, 5, link="datacenter"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert rec.init_bits(port, d) == jax_rec.init_bits(ref, d)


def _serial(method_spec, x0, n, seed):
    prob = torch_problem()
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    return method_spec.build(oracles).run(x0, n, ROUNDS, seed=seed)[1]


def test_sweep_equals_serial_runs_bitwise():
    """A sweep cell is its seeds' serial runs, bit for bit; distinct seeds
    give distinct Rand-K trajectories."""
    prob = torch_problem()
    x0 = torch.from_numpy(shared_x0())
    specs = [
        ExperimentSpec("fednl", "topk", 123, params=dict(option=2),
                       seeds=(0, 1), num_rounds=ROUNDS),
        ExperimentSpec("fednl", "randk", 123,
                       params=dict(option=1, mu=MU, alpha=1 / 123),
                       seeds=(0, 1, 2), num_rounds=ROUNDS),
        ExperimentSpec("fednl-pp", "blocktopk", 8, params=dict(tau=TAU),
                       seeds=(3,), num_rounds=ROUNDS),
        ExperimentSpec("fednl-cohort", "topk", 123,
                       cohort=CohortSpec(cohort=TAU), seeds=(0,),
                       num_rounds=ROUNDS),
    ]
    res = run_sweep(specs, prob, x0=x0)
    for spec, cell in zip(specs, res.cells):
        for i, seed in enumerate(spec.seeds):
            want = _serial(spec, x0, prob["n"], seed)
            assert torch.equal(torch.from_numpy(cell.xs[i]), want), spec.label
        assert np.all(np.isfinite(cell.gaps)) and cell.us_per_round > 0
    randk = res.cell("fednl:randk123").xs
    assert not np.array_equal(randk[0], randk[1])
    assert not np.array_equal(randk[1], randk[2])


def test_labels_and_spec_build():
    cohort = CohortSpec(cohort=4, population=16)
    for kw in (dict(method="fednl", compressor="topk", level=7),
               dict(method="fednl", compressor="rankr", level=1.5),
               dict(method="newton"),
               dict(method="fednl", compressor="topk", level=3, name="mine")):
        with jax.enable_x64(True):
            want = JaxSpec(**kw).label
        assert ExperimentSpec(**kw).label == want
    spec = ExperimentSpec("fednl-cohort", "topk", 10, cohort=cohort)
    with jax.enable_x64(True):
        assert spec.label == JaxSpec(
            "fednl-cohort", "topk", 10,
            cohort=JaxCohortSpec(cohort=4, population=16)).label
    prob = torch_problem()
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    method = spec.build(oracles)
    assert method.cohort is cohort and method.tau == 4
    bc = ExperimentSpec("fednl-bc", "topk", 10, params=dict(
        model_compressor=("topk", 5), p=0.5)).build(oracles)
    assert bc.comp_m == make_compressor("topk", 5)
    assert ExperimentSpec("fednl", seeds=[2, 3]).seeds == (2, 3)
    res = Sweep([ExperimentSpec("fednl", "topk", 123, num_rounds=1)],
                link=None).run(prob)
    assert res.cells[0].seconds_per_round is None
    assert np.isnan(res.records()[0]["seconds_per_round"])
    with pytest.raises(KeyError):
        res.cell("nope")
    from repro_torch.engine import CohortSpec as Lazy
    assert Lazy is CohortSpec


def test_mesh_and_sharded_raise_naming_item_10():
    with pytest.raises(NotImplementedError, match="item 10"):
        Sweep([ExperimentSpec("fednl", "topk", 4)], mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(["--device", "cpu", "--sharded"])


def _header(capsys) -> list:
    return capsys.readouterr().out.strip().splitlines()[0].split(",")


@pytest.mark.parametrize("mode", [["--target", "1e-6"], ["--records"]],
                         ids=["summary", "records"])
def test_cli_runs_on_cpu_with_the_reference_header(mode, capsys):
    args = ["--problem", "a1a", "--method", "fednl", "--compressor", "topk",
            "--levels", "20,40", "--seeds", "0,1", "--rounds", "2",
            "--option", "2"] + mode
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    ours = out[0].split(",")
    rows = [line.split(",") for line in out[1:]]
    assert len(rows) == (2 if "--target" in mode else 2 * 2 * 3)
    # the reference in f32: --no-x64 leaves its global flag alone
    assert jax_cli.main(args + ["--no-x64"]) == 0
    assert _header(capsys) == ours


def test_parse_libsvm_and_partition_match_reference():
    rng = np.random.default_rng(9)
    lines = []
    for _ in range(23):
        idx = np.sort(rng.choice(np.arange(1, 31), 6, replace=False))
        feats = " ".join(f"{i}:{v:.4g}" for i, v in
                         zip(idx, rng.standard_normal(6)))
        lines.append(f"{rng.choice(['+1', '-1', '0'])} {feats}")
    text = "\n".join(lines[:10] + [""] + lines[10:]) + "\n"
    for d in (None, 30, 20):
        a, b = libsvm.parse_libsvm(text, d)
        ja, jb = jax_libsvm.parse_libsvm(text, d)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        assert a.dtype == ja.dtype and b.dtype == jb.dtype
    a, b = libsvm.parse_libsvm(text)
    data = libsvm.partition_across_silos(a, b, 4, lam=0.01, device="cpu")
    with jax.enable_x64(True):
        want = jax_libsvm.partition_across_silos(a, b, 4, lam=0.01)
    assert data.a.shape == (4, 5, 30) and data.lam == want.lam
    np.testing.assert_array_equal(data.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(data.b.numpy(), np.asarray(want.b))


def _reference_draws(kind, key, n, m, d):
    """The variates the reference's ``make_synthetic`` / ``make_iid``
    draws from ``key``, named as the port's draw functions name them."""
    jr = jax.random
    if kind == "synthetic":
        ks = jr.split(key, 7)
        shapes = [(n,), (n, d), (n, m, d), (n,), (n,), (n, d)]
        z = {f"z{i}": jr.normal(ks[i], s) for i, s in enumerate(shapes)}
        z["u"] = jr.uniform(ks[6], (n, m), jnp.float64)
    else:
        ks = jr.split(key, 6)
        shapes = [(n,), (n, m, d), (d,), ()]
        z = {f"z{i}": jr.normal(ks[i], s) for i, s in enumerate(shapes)}
        z["u"] = jr.uniform(ks[4], (n, m), jnp.float64)
    return {k: torch.from_numpy(np.array(v)) for k, v in z.items()}


@pytest.mark.parametrize("kind", ["synthetic", "iid"])
def test_synthetic_construction_matches_reference_draws(kind):
    n, m, d = 6, 30, 10
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(5)
        z = _reference_draws(kind, key, n, m, d)
        if kind == "synthetic":
            want = jax_synthetic.make_synthetic(key, 0.5, 1.5, n, m, d)
            got = synthetic.synthetic_from_draws(z, 0.5, 1.5)
        else:
            want = jax_synthetic.make_iid(key, 0.7, n, m, d)
            got = synthetic.iid_from_draws(z, 0.7)
    assert got.a.dtype == torch.float64 and got.a.shape == (n, m, d)
    # sqrt(j^-1.2) is an f32 power in both packages (one rounding apart)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    gen = torch.Generator().manual_seed(0)
    drawn = (synthetic.make_synthetic(gen, 0.5, 0.5, n, m, d)
             if kind == "synthetic" else synthetic.make_iid(gen, 0.5, n, m, d))
    assert drawn.a.shape == (n, m, d)
    assert set(drawn.b.unique().tolist()) <= {-1.0, 1.0}


def test_make_problem_synthetic():
    prob = make_problem("synthetic:0.5:0.5", device="cpu")
    assert (prob["n"], prob["d"]) == (30, 100)
    g = torch.mean(prob["grad"](prob["xstar"]), dim=0)
    assert float(torch.linalg.vector_norm(g)) < 1e-10
    with pytest.raises(ValueError, match="synthetic:ALPHA:BETA"):
        make_problem("nope", device="cpu")


@pytest.mark.parametrize("module", ["repro_torch.wire", "repro_torch.core",
                                    "repro_torch.engine"])
def test_import_order_has_no_cycle(module):
    """The wire package, the core and the engine import one another:
    each imports first, in a fresh process, without a cycle."""
    code = (f"import {module}; import repro_torch.engine as e; "
            f"assert e.CohortSpec is not None and e.wire_cost")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
