"""FedNL and its variants on the w8a stand-in (n=142, m=350, d=300, f64)
with the JAX reference package: ||x^k - x*|| after 20 rounds from
x0 = 0 for each run that ``chip_smoke.py`` makes on the port. The port's
bounds in ``chip_smoke.py`` come from this script's output.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py --variants [--only pp-topk-tau28,cr-topk]
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py --sweep [--only a,b]

Without a mode: Algorithm 1 per compressor and option (phase 4).
``--variants``: the variants of the phase "FedNL variants on w8a", each
randomized one over seeds 0-4 and then a summary line with the worst
seed's ratio ||x^20 - x*|| / ||x^0 - x*||. ``--only`` runs the named
variants (a run takes minutes on a CPU, so the full set is worth
splitting across processes).
``--sweep``: the cells of the phase "the engine on w8a" (``SWEEP_CELLS``)
through the reference's ``Sweep``. First, without running anything, one
line per cell with its accounting at n = 142, d = 300 (the summary's
``bits_per_round``, ``bits_per_round_measured``,
``bits_per_round_entropy`` and ``seconds_per_round``) and one line with
``uplink_bits`` of ``fednl_precond`` (k = 2,048 of 128^2) over the
qwen2-0.5B tree with 4 silos; then, per cell (``--only`` picks cells),
its gap ratio (f(x^20) - f*) / (f(x^0) - f*) from x0 = 0, the worst
over seeds 0-4 where the cell draws at random.
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.baselines import Artemis, Diana
from repro.core.compressors import make_compressor
from repro.core.fednl import FedNL
from repro.core.objectives import silo_hess
from repro.data.problems import make_problem
from repro.engine.method import Oracles, make_method

ROUNDS = 20
CASES = [("topk", 300), ("topk-sym", 300), ("rankr", 1), ("blocktopk", 8)]
SEEDS = tuple(range(5))


def subsampled_hess(data, m_sub):
    """Per-round minibatch Hessians: m_sub of each silo's m points."""
    n, m, _ = data.a.shape

    def hess(x, key):
        def one(a, b, k):
            idx = jax.random.choice(k, m, (m_sub,), replace=False)
            return silo_hess(x, a[idx], b[idx], data.lam)

        return jax.vmap(one)(data.a, data.b, jax.random.split(key, n))

    return hess


def variants(prob) -> dict:
    """name -> (build(), randomized): the phase's runs. ``build`` returns
    an object with ``run(x0, n, rounds, seed=)`` and the monitored
    field."""
    d, n = prob["d"], prob["n"]
    data = prob["data"]
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    consts = prob["consts"]
    topk, block = ("topk", d), ("blocktopk", 8)
    randk = make_compressor("randk", d)
    grad_k = make_compressor("randk", d // 10)
    omega = grad_k.spec((d,)).omega
    hstar = jnp.mean(prob["hess"](prob["xstar"]), axis=0)

    def method(name, comp=None, **params):
        return lambda: make_method(name, oracles, comp and make_compressor(
            *comp), **params)

    return {
        "pp-topk-tau28": (method("fednl-pp", topk, tau=28), True),
        "pp-topk-tau71": (method("fednl-pp", topk, tau=71), True),
        "pp-blocktopk-tau28": (method("fednl-pp", block, tau=28), True),
        "pp-blocktopk-tau71": (method("fednl-pp", block, tau=71), True),
        "cr-topk": (method("fednl-cr", topk, l_star=consts["L_star"]), False),
        "ls-blocktopk": (method("fednl-ls", block, mu=1e-3), False),
        "bc-topk": (method("fednl-bc", topk, model_compressor=("topk", d // 2),
                           p=0.5, option=1, mu=1e-3), True),
        "fednl-randk": (lambda: FedNL(
            prob["grad"], prob["hess"], randk, option=1, mu=1e-3,
            alpha=1.0 / (randk.spec((d, d)).omega + 1.0)), True),
        "fednl-powersgd": (method("fednl", ("powersgd", 1), option=2), False),
        "stoch-topk": (method("fednl-stoch", topk, hess_fn_stoch=subsampled_hess(
            data, data.a.shape[1] // 2)), True),
        "ppbc-topk": (method("fednl-ppbc", topk, tau=28,
                             model_compressor=("topk", d // 2)), True),
        "newton": (method("newton"), False),
        "n0": (method("n0"), False),
        "ns": (method("ns", h_fixed=hstar), False),
        "n0-ls": (method("n0-ls"), False),
        "diana-randk": (lambda: Diana(prob["grad"], grad_k, consts["L"], n,
                                      omega), True),
        "artemis-randk": (lambda: Artemis(prob["grad"], grad_k, consts["L"],
                                          n, omega, tau=28), True),
    }


def sweep_cells(d: int) -> dict:
    """name -> (ExperimentSpec, randomized): the engine phase's cells.
    Rand-K takes alpha = 1/(omega + 1) (Assumption 3.5), as phase 4b."""
    from repro.core.cohort import CohortSpec
    from repro.engine import ExperimentSpec

    cohort = CohortSpec(cohort=28)
    randk_alpha = 1.0 / (make_compressor("randk", d).spec((d, d)).omega + 1.0)
    spec = lambda *a, **kw: ExperimentSpec(*a, num_rounds=ROUNDS, **kw)
    return {
        "a": (spec("fednl", "topk", d, params=dict(option=2)), False),
        "b": (spec("fednl", "blocktopk", 8, params=dict(option=2)), False),
        "c": (spec("fednl", "randk", d,
                   params=dict(option=2, alpha=randk_alpha)), True),
        "d": (spec("fednl-pp", "topk", d, params=dict(tau=28)), True),
        "e": (spec("fednl-cohort", "topk", d, cohort=cohort), True),
        "f": (spec("fednl-cohort", "blocktopk", 8, cohort=cohort), True),
    }


def sweep(prob, only) -> None:
    """The ``--sweep`` mode's lines (module docstring)."""
    import dataclasses

    from repro.configs import get_config
    from repro.engine import Sweep
    from repro.engine import records as rec
    from repro.engine.method import Oracles
    from repro.models import build_model
    from repro.second_order.fednl_precond import fednl_precond

    d, n = prob["d"], prob["n"]
    oracles = Oracles(prob["val"], prob["grad"], prob["hess"])
    cells = sweep_cells(d)
    for name, (spec, _) in cells.items():
        method = spec.build(oracles)
        link, k = ((spec.cohort.link, spec.cohort.cohort) if spec.cohort
                   else ("wan", n))
        print(json.dumps(dict(
            cell=name, label=spec.label,
            bits_per_round=float(rec.uplink_bits_per_round(method, d)),
            bits_per_round_measured=rec.measured_bits_per_round(method, d),
            bits_per_round_entropy=rec.measured_bits_per_round(
                method, d, index_coding="entropy"),
            seconds_per_round=rec.seconds_per_round(method, d, k,
                                                    link=link))), flush=True)
    model = build_model(get_config("qwen2-0.5b"))
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    opt = fednl_precond(k_per_block=2048, block=128)
    print(json.dumps(dict(uplink_bits_qwen2_4_silos=opt.uplink_bits(
        shapes, n_silos=4))), flush=True)
    for name in only or cells:
        spec, randomized = cells[name]
        spec = dataclasses.replace(spec, seeds=SEEDS if randomized else (0,))
        t = time.perf_counter()
        cell = Sweep([spec]).run(prob, x0=jnp.zeros(d)).cells[0]
        ratios = cell.gaps[:, -1] / cell.gaps[:, 0]
        print(json.dumps(dict(
            cell=name, label=spec.label, seeds=len(spec.seeds),
            gap0=float(cell.gaps[0, 0]), gap_final=cell.gaps[:, -1].tolist(),
            worst_gap_ratio=float(ratios.max()),
            seconds=time.perf_counter() - t)), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", action="store_true",
                        help="the variants phase's runs instead of phase 4's")
    parser.add_argument("--sweep", action="store_true",
                        help="the engine phase's accounting and gap ratios")
    parser.add_argument("--only", default="",
                        help="comma-separated variant or cell names "
                             "(default: all)")
    args = parser.parse_args()
    with jax.enable_x64(True):
        prob = make_problem("w8a")
        d, n = prob["d"], prob["n"]
        x0 = jnp.zeros(d)
        if args.sweep:
            sweep(prob, [c for c in args.only.split(",") if c])
            return
        if not args.variants:
            for family, level in CASES:
                for option in (1, 2):
                    t = time.perf_counter()
                    alg = FedNL(prob["grad"], prob["hess"],
                                make_compressor(family, level), option=option,
                                mu=1e-3)
                    _, xs = alg.run(x0, n, ROUNDS)
                    err = np.linalg.norm(np.asarray(xs - prob["xstar"]),
                                         axis=1)
                    print(json.dumps(dict(
                        compressor=family, level=level, option=option,
                        err0=float(err[0]), err_final=float(err[-1]),
                        err_min=float(err.min()),
                        seconds=time.perf_counter() - t)), flush=True)
            return
        runs = variants(prob)
        for name in args.only.split(",") if args.only else runs:
            build, randomized = runs[name]
            ratios = []
            for seed in (SEEDS if randomized else (0,)):
                t = time.perf_counter()
                _, xs = build().run(x0, n, ROUNDS, seed=seed)
                err = np.linalg.norm(np.asarray(xs - prob["xstar"]), axis=1)
                ratios.append(float(err[-1] / err[0]))
                print(json.dumps(dict(
                    variant=name, seed=seed, err0=float(err[0]),
                    err_final=float(err[-1]), ratio=ratios[-1],
                    seconds=time.perf_counter() - t)), flush=True)
            print(json.dumps(dict(variant=name, seeds=len(ratios),
                                  worst_ratio=max(ratios))), flush=True)


if __name__ == "__main__":
    main()
