"""End-to-end paper experiment on the PyTorch port: FedNL vs first-order
baselines on the a1a-shaped problem (Table 3 sizes), with the paper's
communicated-bits accounting, PLUS the same FedNL run with the silo data
split over the ranks of a process group (``core/federated.py``). Runs on
the card unless given ``--device cpu``, in f64.

    PYTHONPATH=src python examples/torch_fednl_federated_logreg.py

Started alone, the sharded cell runs on a one-rank group; under
``torchrun`` every rank runs the whole script and prints, and the
sharded cell splits the silos over the ranks:

    PYTHONPATH=src torchrun --nproc-per-node 2 --master-addr localhost \\
        --master-port 29533 examples/torch_fednl_federated_logreg.py \\
        --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
import torch.distributed as dist

from repro_torch.core import RandomDithering
from repro_torch.core.baselines import Diana, gd_run
from repro_torch.core.compressors import FLOAT_BITS
from repro_torch.data.problems import problem_from_data
from repro_torch.data.synthetic import make_libsvm_like
from repro_torch.device import resolve_device
from repro_torch.engine import ExperimentSpec, Sweep
from repro_torch.launch.mesh import make_host_mesh, scoped_group

SHOWN_ROUNDS = (0, 2, 5, 10, 15, 20)


def fednl(prob: dict, x0: torch.Tensor, *, rounds: int = 20,
          sharded_rounds: int = 10) -> dict:
    """The FedNL Rank-1 cell (Option 1, mu = 1e-3) through the engine,
    then the Option-2 cell on a ``make_host_mesh`` over the process group
    (one joined or made here, and then destroyed); prints both. Returns
    the cells."""
    spec = ExperimentSpec("fednl", "rankr", 1, params=dict(option=1, mu=1e-3),
                          num_rounds=rounds, name="FedNL-Rank1")
    cell = Sweep([spec]).run(prob, x0=x0).cells[0]
    print("\nFedNL (Rank-1):    bits/node        f - f*")
    for k in (k for k in SHOWN_ROUNDS if k <= rounds):
        print(f"  round {k:3d}   {cell.bits[k]:12.3e}   {cell.gaps[0, k]:.3e}")

    # the same spec, its silos split over the mesh (core/federated.py path)
    spec_sh = ExperimentSpec("fednl", "rankr", 1, params=dict(option=2),
                             num_rounds=sharded_rounds, name="FedNL-sharded")
    with scoped_group():
        mesh = make_host_mesh(device=x0.device)
        world = dist.get_world_size()
        cell_sh = Sweep([spec_sh], mesh=mesh).run(prob, x0=x0).cells[0]
    print(f"\nsharded execution over {world} rank(s): gap after "
          f"{sharded_rounds} rounds = {cell_sh.gaps[0, -1]:.3e}")
    return {"cell": cell, "sharded": cell_sh, "world": world}


def baselines(prob: dict, x0: torch.Tensor, *, gd_rounds: int = 2000,
              diana_rounds: int = 2000, draws=None) -> dict:
    """GD at 1/L and DIANA with random dithering (s = sqrt(d)) from x0;
    ``draws`` is DIANA's round-draw source (its own ``RoundDraws(0)`` when
    None). Returns the iterates, gaps and bits a node."""
    n, d, smooth = prob["n"], prob["d"], prob["consts"]["L"]
    _, xs_gd = gd_run(x0, prob["grad"], 1.0 / smooth, gd_rounds)
    rd = RandomDithering(s=int(d ** 0.5))
    diana = Diana(prob["grad"], rd, smooth, n, rd.spec((d,)).omega)
    kw = {} if draws is None else {"draws": draws}
    _, xs_di = diana.run(x0, n, diana_rounds, **kw)
    return {"xs_gd": xs_gd, "xs_diana": xs_di,
            "gap_gd": float(prob["val"](xs_gd[-1])) - prob["fstar"],
            "gap_diana": float(prob["val"](xs_di[-1])) - prob["fstar"],
            "bits_gd": gd_rounds * d * FLOAT_BITS,
            "bits_diana": diana_rounds * diana.bits_per_round(d)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data = make_libsvm_like(torch.Generator(device=dev).manual_seed(0), "a1a",
                            lam=1e-3, dtype=torch.float64)
    prob = problem_from_data(data)       # x* by 25 Newton rounds from 0
    n, m, d = data.a.shape
    x0 = prob["xstar"] + 0.05 * torch.randn(
        d, generator=torch.Generator(device=dev).manual_seed(1),
        dtype=torch.float64, device=dev)
    print(f"a1a-shaped: n={n} silos, m={m} points/silo, d={d}, "
          f"kappa~{prob['consts']['L'] / 1e-3:.0f}")

    out = fednl(prob, x0, rounds=20, sharded_rounds=10)
    base = baselines(prob, x0, gd_rounds=2000, diana_rounds=2000)
    cell = out["cell"]
    print(f"\nGD    after {base['bits_gd']:.2e} bits/node: gap "
          f"{base['gap_gd']:.3e}")
    print(f"DIANA after {base['bits_diana']:.2e} bits/node: gap "
          f"{base['gap_diana']:.3e}")
    print(f"FedNL after {cell.bits[20]:.2e} bits/node: gap "
          f"{cell.gaps[0, 20]:.3e}   <-- the paper's headline")
    return {**out, **base}


if __name__ == "__main__":
    main()
