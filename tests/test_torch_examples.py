"""The port's five example scripts (``examples/torch_*.py``) against the
reference on the CPU.

The scripts are loaded by path; the reference's own scripts are never
imported (they set ``jax_enable_x64`` at import). Each FedNL example's
functions are handed the reference's arrays, with fewer rounds than the
scripts' ``main`` runs, and their outputs held to the reference's
engine on the same arrays:

* quickstart: f32, as the reference runs (no x64): f(x) at the printed
  rounds to 5e-6 relative (1.7e-6 measured: f32 sums, eigh and Newton
  solves round differently in the two packages, f(0) = log 2 already
  6e-7 apart); the uplink bits exactly;
* federated logreg: f64, the FedNL Rank-1 cell's gaps to 1e-10 and its
  bits exactly, the sharded cell on a one-rank gloo group to 1e-10, GD's
  iterates to 1e-12, DIANA's (the reference's draws replayed) to 1e-8,
  both at the reference's L, the bit totals exactly;
* heterogeneity: f64, synthetic(1, 1), the worst-of-3-seeds FedNL gap to
  1e-10 and GD's iterates to 1e-12.

Serving and training run through ``main`` on the CPU: ``generate`` and
the train step are held to the reference by ``test_torch_models.py``,
``test_torch_ssm.py`` and ``test_torch_train.py`` (the reference's
``serve_batched.py`` and ``train_lm.py`` fail on jax 0.9.0).
"""

import ast
import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import one_rank_group
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_parity import jax_a1a_oracles, port_problem, reference_a1a
from _torch_replay import schedule
from repro.core import baselines as jb
from repro.core.compressors import FLOAT_BITS as JAX_FLOAT_BITS
from repro.core.compressors import RandomDithering as JaxRandomDithering
from repro.core.newton import newton_run as jax_newton_run
from repro.core.objectives import batch_grad as jax_batch_grad
from repro.core.objectives import batch_hess as jax_batch_hess
from repro.core.objectives import global_value as jax_global_value
from repro.core.objectives import lipschitz_constants as jax_lipschitz
from repro.data import synthetic as jax_synthetic
from repro.engine import ExperimentSpec as JaxSpec
from repro.engine import Oracles as JaxOracles
from repro.engine import Sweep as JaxSweep
from repro.engine import build_compressor as jax_build_compressor
from repro.engine import make_method as jax_make_method
from repro_torch.data import problem_from_data
from repro_torch.engine import ExperimentSpec, Sweep
from repro_torch.interop import logreg_from_numpy
from repro_torch.launch.serve import generate

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ["quickstart", "fednl_federated_logreg", "heterogeneity",
         "serve_batched", "train_lm"]


@functools.lru_cache(maxsize=None)
def example(name: str):
    """``examples/torch_<name>.py`` as a module, loaded by path; the
    script's own ``sys.path`` entry is taken back out."""
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    before = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = before
    return mod


def _jax_problem(data) -> dict:
    """The reference's oracle dict on its data, as its scripts build it
    (use inside the x64 setting the data was made in)."""
    grad = lambda x: jax_batch_grad(x, data)
    hess = lambda x: jax_batch_hess(x, data)
    val = lambda x: jax_global_value(x, data)
    n, _, d = data.a.shape
    xstar, _ = jax_newton_run(jnp.zeros(d), grad, hess, 25)
    return dict(data=data, grad=grad, hess=hess, val=val, n=n, d=d,
                xstar=xstar, fstar=float(val(xstar)))


def _jax_x0(xstar):
    return xstar + 0.05 * jax.random.normal(jax.random.PRNGKey(1),
                                            xstar.shape)


# -- every script ---------------------------------------------------------------


def _imported_modules(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_no_jax_and_no_reference(name):
    tree = ast.parse((EXAMPLES / f"torch_{name}.py").read_text())
    roots = {mod.split(".")[0] for mod in _imported_modules(tree)}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots
    # a main(argv=None) that a test can call with arguments
    mains = [node for node in tree.body if isinstance(node, ast.FunctionDef)
             and node.name == "main"]
    assert len(mains) == 1 and [a.arg for a in mains[0].args.args] == ["argv"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
@pytest.mark.parametrize("name", NAMES)
def test_example_without_device_raises_without_cuda(name):
    """No ``--device`` means the card: with none, ``resolve_device``'s
    error, before any work and with no process group left."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example(name).main([])
    assert not dist.is_initialized()


# -- quickstart (f32) ---------------------------------------------------------


def test_quickstart_matches_reference_in_f32(capsys):
    with jax.enable_x64(False):
        data = jax_synthetic.make_synthetic(jax.random.PRNGKey(0), alpha=0.5,
                                            beta=0.5, n=16, m=100, d=60,
                                            lam=1e-3)
        assert data.a.dtype == jnp.float32
        oracles = JaxOracles(lambda x: jax_global_value(x, data),
                             lambda x: jax_batch_grad(x, data),
                             lambda x: jax_batch_hess(x, data))
        alg = jax_make_method("fednl", oracles,
                              jax_build_compressor("rankr", 1), alpha=1.0,
                              option=1, mu=1e-3)
        _, xs = alg.run(jnp.zeros(60), n=16, num_rounds=20)
        want = {k: float(jax_global_value(xs[k], data))
                for k in (0, 1, 2, 5, 10, 20)}
        want_bits = alg.bits_per_round(60)
    port = logreg_from_numpy(np.asarray(data.a), np.asarray(data.b),
                             float(data.lam), device="cpu",
                             dtype=torch.float32)
    got = example("quickstart").quickstart(port, num_rounds=20)
    assert set(got["values"]) == set(want)
    for k, v in want.items():
        assert got["values"][k] == pytest.approx(v, rel=5e-6, abs=0), k
    assert got["bits_per_round"] == want_bits == 1456 * 8
    out = capsys.readouterr().out
    assert "uplink per device per round: 1456 bytes (vs 14640 bytes" in out
    assert len(re.findall(r"round +\d+  f\(x\) = ", out)) == 6


# -- federated logreg (f64) ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _logreg_reference(rounds: int, sharded_rounds: int, gd_rounds: int,
                      diana_rounds: int) -> dict:
    ref = jax_a1a_oracles()
    with jax.enable_x64(True):
        prob = _jax_problem(ref["data"])
        x0 = _jax_x0(prob["xstar"])
        spec = JaxSpec("fednl", "rankr", 1, params=dict(option=1, mu=1e-3),
                       num_rounds=rounds, name="FedNL-Rank1")
        cell = JaxSweep([spec]).run(prob, x0=x0).cells[0]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        spec_sh = JaxSpec("fednl", "rankr", 1, params=dict(option=2),
                          num_rounds=sharded_rounds, name="FedNL-sharded")
        cell_sh = JaxSweep([spec_sh], mesh=mesh).run(prob, x0=x0).cells[0]
        smooth = jax_lipschitz(ref["data"])["L"]
        d, n = prob["d"], prob["n"]
        _, xs_gd = jb.gd_run(x0, prob["grad"], 1.0 / smooth, gd_rounds)
        rd = JaxRandomDithering(s=int(d ** 0.5))
        diana = jb.Diana(prob["grad"], rd, smooth, n, rd.spec((d,)).omega)
        _, xs_di = diana.run(x0, n, diana_rounds)
        return dict(x0=np.asarray(x0), smooth=smooth,
                    gaps=np.asarray(cell.gaps),
                    bits=np.asarray(cell.bits),
                    gaps_sh=np.asarray(cell_sh.gaps),
                    xs_gd=np.asarray(xs_gd), xs_diana=np.asarray(xs_di),
                    bits_gd=gd_rounds * d * JAX_FLOAT_BITS,
                    bits_diana=diana_rounds * diana.bits_per_round(d))


def test_federated_logreg_matches_reference(capsys):
    rounds, sharded_rounds, gd_rounds, diana_rounds = 10, 10, 100, 50
    want = _logreg_reference(rounds, sharded_rounds, gd_rounds, diana_rounds)
    prob = port_problem(reference_a1a())
    # the reference's a1a features are f32, and so is its L (4.7584996...
    # against the port's f64 4.7585000...): the port is handed it, as it
    # is handed the arrays
    prob["consts"] = {**prob["consts"], "L": want["smooth"]}
    x0 = torch.from_numpy(want["x0"].copy())
    ex = example("fednl_federated_logreg")
    with one_rank_group():
        got = ex.fednl(prob, x0, rounds=rounds, sharded_rounds=sharded_rounds)
        assert dist.is_initialized()        # the group it joined stays
    assert got["world"] == 1
    np.testing.assert_array_equal(got["cell"].bits, want["bits"])
    shown = [k for k in ex.SHOWN_ROUNDS if k <= rounds]
    np.testing.assert_allclose(got["cell"].gaps[0, shown],
                               want["gaps"][0, shown], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["sharded"].gaps[0, -1],
                               want["gaps_sh"][0, -1], rtol=0, atol=1e-10)
    n, d = prob["n"], prob["d"]
    rd = ex.RandomDithering(s=int(d ** 0.5))
    base = ex.baselines(prob, x0, gd_rounds=gd_rounds,
                        diana_rounds=diana_rounds,
                        draws=schedule("diana", 0, diana_rounds, n, d,
                                       comp=rd))
    np.testing.assert_allclose(base["xs_gd"].numpy(), want["xs_gd"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(base["xs_diana"].numpy(), want["xs_diana"],
                               rtol=0, atol=1e-8)
    assert base["bits_gd"] == want["bits_gd"]
    assert base["bits_diana"] == want["bits_diana"]
    out = capsys.readouterr().out
    assert "sharded execution over 1 rank(s): gap after 10 rounds" in out
    assert len(re.findall(r"  round +\d+ ", out)) == len(shown)


def test_federated_logreg_makes_and_destroys_its_own_group():
    """Started with no process group, the sharded cell makes a one-rank
    group and destroys it; the cell equals the serial Option-2 run."""
    prob = port_problem(reference_a1a())
    x0 = prob["xstar"] + 0.05
    assert not dist.is_initialized()
    got = example("fednl_federated_logreg").fednl(prob, x0, rounds=2,
                                                  sharded_rounds=3)
    assert not dist.is_initialized()
    spec = ExperimentSpec("fednl", "rankr", 1, params=dict(option=2),
                          num_rounds=3)
    serial = Sweep([spec]).run(prob, x0=x0).cells[0]
    np.testing.assert_array_equal(got["sharded"].xs, serial.xs)


# -- heterogeneity (f64) -------------------------------------------------------


def test_heterogeneity_matches_reference(capsys):
    fednl_rounds, gd_rounds = 15, 100
    with jax.enable_x64(True):
        data = jax_synthetic.make_synthetic(jax.random.PRNGKey(0), 1.0, 1.0)
        prob = _jax_problem(data)
        x0 = _jax_x0(prob["xstar"])
        spec = JaxSpec("fednl", "rankr", 1, params=dict(option=2),
                       seeds=(0, 1, 2), num_rounds=fednl_rounds, name="FedNL")
        cell = JaxSweep([spec]).run(prob, x0=x0).cells[0]
        want_gap = float(np.max(cell.gaps[:, -1]))
        _, want_gd = jb.gd_run(x0, prob["grad"],
                               1.0 / jax_lipschitz(data)["L"], gd_rounds)
        want_gd = np.asarray(want_gd)
    port = problem_from_data(logreg_from_numpy(
        np.asarray(data.a), np.asarray(data.b), float(data.lam),
        device="cpu", dtype=torch.float64))
    got = example("heterogeneity").heterogeneity_row(
        port, torch.from_numpy(np.array(x0)), "synthetic(1,1)",
        fednl_rounds=fednl_rounds, gd_rounds=gd_rounds)
    assert got["cell"].gaps.shape == (3, fednl_rounds + 1)
    assert got["gap_fednl"] == pytest.approx(want_gap, rel=0, abs=1e-10)
    np.testing.assert_allclose(got["xs_gd"].numpy(), want_gd, rtol=0,
                               atol=1e-12)
    assert "synthetic(1,1)   FedNL gap@15 rounds (worst of 3 seeds)" in (
        capsys.readouterr().out)


# -- serving and training, through main ----------------------------------------


def test_serve_main_prints_generate_on_cpu(capsys):
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen",
            "5"]
    seqs = example("serve_batched").main(argv)
    out = capsys.readouterr().out
    want = generate("xlstm-350m", smoke=True, batch=2, prompt_len=6, gen=5,
                    device="cpu")
    assert torch.equal(seqs, want) and seqs.shape == (2, 11)
    for i in range(2):
        assert f"request {i}: {want[i].tolist()}\n" in out


def test_train_main_runs_fednl_on_cpu(capsys):
    hist = example("train_lm").main(["--device", "cpu", "--steps", "3",
                                     "--optimizer", "fednl",
                                     "--refresh-every", "2"])
    assert not dist.is_initialized()        # its one-rank group is gone
    assert len(hist) == 3 and all(np.isfinite(hist))
    out = capsys.readouterr().out
    assert f"loss: {hist[0]:.3f} -> {hist[-1]:.3f} over 3 steps (fednl)" in out
    # refreshes on steps 0 and 2: the uplink of two refreshes by step 2
    per = int(re.search(r"curvature uplink: (\d+) bits/refresh", out)[1])
    assert f"curv_bits {2 * per} " in out
