"""Quickstart on the PyTorch port: FedNL (Algorithm 1) on a federated
logistic regression, constructed declaratively through the experiment
engine's registry. Runs on the card unless given ``--device cpu``, in
f32 throughout.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core.objectives import batch_grad, batch_hess, global_value
from repro_torch.data.synthetic import make_synthetic
from repro_torch.device import resolve_device
from repro_torch.engine import (
    Oracles,
    available_methods,
    build_compressor,
    make_method,
)

SHOWN_ROUNDS = (0, 1, 2, 5, 10, 20)


def quickstart(data, *, num_rounds: int = 20) -> dict:
    """FedNL with Rank-1 compression from x0 = 0 on ``data`` (n silos of
    a ``LogRegData``), in ``data``'s type and on its device. Prints f(x)
    at the shown rounds up to ``num_rounds`` and the uplink bytes a
    round; returns {round: f(x)} and the uplink bits a round."""
    n, _, d = data.a.shape
    oracles = Oracles(
        value=lambda x: global_value(x, data),  # x -> f(x)
        grad=lambda x: batch_grad(x, data),     # x -> (n, d) per-silo gradients
        hess=lambda x: batch_hess(x, data),     # x -> (n, d, d) per-silo Hessians
    )
    # any method in the family is constructible by name; FedNL with Rank-1
    # compression is the paper's best configuration
    print("registered methods:", ", ".join(available_methods()))
    alg = make_method("fednl", oracles, build_compressor("rankr", 1),
                      alpha=1.0, option=1, mu=1e-3)

    x0 = torch.zeros(d, dtype=data.a.dtype, device=data.a.device)
    _, xs = alg.run(x0, n=n, num_rounds=num_rounds)

    values = {}
    for k in (k for k in SHOWN_ROUNDS if k <= num_rounds):
        values[k] = float(global_value(xs[k], data))
        print(f"round {k:3d}  f(x) = {values[k]:.12f}")
    bits = alg.bits_per_round(d)
    print(f"\nuplink per device per round: {bits / 8:.0f} bytes "
          f"(vs {d * (d + 1) // 2 * 8} bytes for a full Hessian)")
    return {"values": values, "bits_per_round": bits}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # a cross-silo problem: n=16 silos, heterogeneous data (Sec. A.14)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = make_synthetic(gen, alpha=0.5, beta=0.5, n=16, m=100, d=60,
                          lam=1e-3, dtype=torch.float32)
    return quickstart(data, num_rounds=20)


if __name__ == "__main__":
    main()
