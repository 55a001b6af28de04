"""Fig. 14 scenario on the PyTorch port: how statistical heterogeneity
(synthetic(alpha, beta)) affects FedNL vs gradient descent. The FedNL
cells run as declarative engine sweeps of 3 seeds each; the port runs a
cell's seeds one after another, each bit for bit a serial ``run``. Runs
on the card unless given ``--device cpu``, in f64.

    PYTHONPATH=src python examples/torch_heterogeneity.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.baselines import gd_run
from repro_torch.data.problems import problem_from_data
from repro_torch.data.synthetic import make_iid, make_synthetic
from repro_torch.device import resolve_device
from repro_torch.engine import ExperimentSpec, Sweep

PROBLEMS = [
    ("IID", lambda g: make_iid(g, n=30, m=200, d=100, dtype=torch.float64)),
    ("synthetic(0,0)",
     lambda g: make_synthetic(g, 0.0, 0.0, dtype=torch.float64)),
    ("synthetic(1,1)",
     lambda g: make_synthetic(g, 1.0, 1.0, dtype=torch.float64)),
]


def heterogeneity_row(prob: dict, x0: torch.Tensor, tag: str, *,
                      fednl_rounds: int = 15, gd_rounds: int = 1500,
                      seeds=(0, 1, 2)) -> dict:
    """FedNL Rank-1 (Option 2) over ``seeds`` through ``Sweep`` and GD at
    1/L from x0 on one problem's oracle dict; prints the worst seed's
    FedNL gap and GD's gap. Returns both and the cell."""
    spec = ExperimentSpec("fednl", "rankr", 1, params=dict(option=2),
                          seeds=seeds, num_rounds=fednl_rounds, name="FedNL")
    cell = Sweep([spec]).run(prob, x0=x0).cells[0]
    gap_fednl = float(np.max(cell.gaps[:, -1]))  # worst of the seeds
    _, xs_gd = gd_run(x0, prob["grad"], 1.0 / prob["consts"]["L"], gd_rounds)
    gap_gd = float(prob["val"](xs_gd[-1])) - prob["fstar"]
    print(f"{tag:16s} FedNL gap@{fednl_rounds} rounds (worst of "
          f"{len(seeds)} seeds): {gap_fednl:9.2e}   GD gap@{gd_rounds} "
          f"rounds: {gap_gd:9.2e}")
    return {"gap_fednl": gap_fednl, "gap_gd": gap_gd, "cell": cell,
            "xs_gd": xs_gd}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = {}
    for tag, maker in PROBLEMS:
        data = maker(torch.Generator(device=dev).manual_seed(0))
        prob = problem_from_data(data)   # x* by 25 Newton rounds from 0
        x0 = prob["xstar"] + 0.05 * torch.randn(
            prob["d"], generator=torch.Generator(device=dev).manual_seed(1),
            dtype=torch.float64, device=dev)
        rows[tag] = heterogeneity_row(prob, x0, tag, fednl_rounds=15,
                                      gd_rounds=1500)
    print("\nFedNL is insensitive to heterogeneity; GD's tail is kappa-limited "
          "regardless (the paper's Fig. 14 story).")
    return rows


if __name__ == "__main__":
    main()
