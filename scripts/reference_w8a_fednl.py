"""FedNL and its variants on the w8a stand-in (n=142, m=350, d=300, f64)
with the JAX reference package: ||x^k - x*|| after 20 rounds from
x0 = 0 for each run that ``chip_smoke.py`` makes on the port. The port's
bounds in ``chip_smoke.py`` come from this script's output.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py --variants [--only pp-topk-tau28,cr-topk]

Without ``--variants``: Algorithm 1 per compressor and option (phase 4).
With it: the variants of the phase "FedNL variants on w8a", each
randomized one over seeds 0-4 and then a summary line with the worst
seed's ratio ||x^20 - x*|| / ||x^0 - x*||. ``--only`` runs the named
variants (a run takes minutes on a CPU, so the full set is worth
splitting across processes).
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
SEEDS = range(5)


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", action="store_true",
                        help="the variants phase's runs instead of phase 4's")
    parser.add_argument("--only", default="",
                        help="comma-separated variant names (default: all)")
    args = parser.parse_args()
    with jax.enable_x64(True):
        prob = make_problem("w8a")
        d, n = prob["d"], prob["n"]
        x0 = jnp.zeros(d)
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
