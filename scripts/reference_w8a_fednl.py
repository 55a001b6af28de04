"""FedNL on the w8a stand-in (n=142, m=350, d=300, f64) with the JAX
reference package: ||x^k - x*|| after 20 rounds for each compressor and
option that ``chip_smoke.py`` runs on the port. The port's bounds in
``chip_smoke.py`` come from this script's output.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_w8a_fednl.py
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.compressors import make_compressor
from repro.core.fednl import FedNL
from repro.data.problems import make_problem

ROUNDS = 20
CASES = [("topk", 300), ("topk-sym", 300), ("rankr", 1), ("blocktopk", 8)]


def main() -> None:
    with jax.enable_x64(True):
        prob = make_problem("w8a")
        d, n = prob["d"], prob["n"]
        x0 = jnp.zeros(d)
        for family, level in CASES:
            for option in (1, 2):
                t = time.perf_counter()
                alg = FedNL(prob["grad"], prob["hess"],
                            make_compressor(family, level), option=option,
                            mu=1e-3)
                _, xs = alg.run(x0, n, ROUNDS)
                err = np.linalg.norm(np.asarray(xs - prob["xstar"]), axis=1)
                print(json.dumps(dict(
                    compressor=family, level=level, option=option,
                    err0=float(err[0]), err_final=float(err[-1]),
                    err_min=float(err.min()),
                    seconds=time.perf_counter() - t)), flush=True)


if __name__ == "__main__":
    main()
