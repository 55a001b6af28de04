"""CLI front-end for the port's experiment engine, counterpart of
``repro.launch.sweep``: run a method x level x seed grid on a named
problem and print tidy records (or a per-cell summary) as CSV, with the
reference's columns — the analytic ``bits``, the payload-measured
``bits_measured``, the entropy-coded ``bits_entropy`` and the traffic
model's ``seconds_per_round`` (``--link`` preset) side by side.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --problem a1a --method fednl --compressor rankr --levels 1,2,4 \\
        --seeds 0,1,2 --rounds 40 --option 1 --mu 1e-3 --target 1e-12

runs on the card (the kernels are built first, so ``us_per_round``
holds no compile); ``--device cpu`` runs on the CPU. A cell's seeds run
one after another (``engine.sweep``). The start is x* + 0.05 N(0, I)
with the normal drawn from ``torch.Generator().manual_seed(1)``: it
differs from the reference's ``PRNGKey(1)`` draw, and so do the
problem's data, drawn from ``torch.Generator`` seeded 0. ``--sharded``
splits the plain-FedNL cells' silos over the ranks of
``launch.mesh.make_host_mesh()``: one rank when started alone, all of
them under ``torchrun``.

    # the sharded path, over every rank torchrun starts
    torchrun --nproc-per-node 4 -m repro_torch.launch.sweep --problem a1a \
        --method fednl --compressor topk --levels 123 --sharded --device cpu
"""

from __future__ import annotations

import argparse
import sys


def _parse_list(s: str, cast=float):
    return [cast(x) for x in s.split(",") if x != ""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--problem", default="a1a",
                    help="a1a | phishing | ... | synthetic:ALPHA:BETA")
    ap.add_argument("--method", default="fednl")
    ap.add_argument("--compressor", default="rankr")
    ap.add_argument("--levels", default="1")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Hessian learning rate (omit for the method default;"
                         " not every method takes one)")
    ap.add_argument("--option", type=int, default=None)
    ap.add_argument("--mu", type=float, default=0.0)
    ap.add_argument("--tau", type=int, default=None)
    ap.add_argument("--lam", type=float, default=1e-3)
    ap.add_argument("--x64", action=argparse.BooleanOptionalAction,
                    default=True, help="run in float64 (--no-x64 for f32)")
    ap.add_argument("--target", type=float, default=None,
                    help="emit per-cell summary with bits/rounds to target")
    ap.add_argument("--records", action="store_true",
                    help="emit full (cell, seed, round) tidy records")
    ap.add_argument("--sharded", action="store_true",
                    help="split FedNL's silos over the host mesh's "
                         "data axis")
    ap.add_argument("--link", default="wan",
                    help="traffic-model link preset for the "
                         "seconds_per_round column (datacenter | wan | "
                         "fl-cross-device | none)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..data.problems import make_problem
    from ..device import resolve_device
    from ..engine import ExperimentSpec, Sweep

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..kernels import build_all

        build_all()
    dtype = torch.float64 if args.x64 else torch.float32

    params = {}
    if args.alpha is not None:
        params["alpha"] = args.alpha
    if args.option is not None:
        params["option"] = args.option
    if args.mu:
        params["mu"] = args.mu
    if args.tau is not None:
        params["tau"] = args.tau

    prob = make_problem(args.problem, args.lam, seed=0, device=dev,
                        dtype=dtype)
    seeds = tuple(int(s) for s in _parse_list(args.seeds, int))
    specs = [
        ExperimentSpec(args.method, args.compressor, lvl, params=params,
                       seeds=seeds, num_rounds=args.rounds)
        for lvl in _parse_list(args.levels)
    ]
    noise = torch.randn(prob["d"], generator=torch.Generator().manual_seed(1),
                        dtype=dtype)
    x0 = prob["xstar"] + 0.05 * noise.to(dev)
    link = None if args.link in ("none", "") else args.link
    mesh = None
    if args.sharded:
        from .mesh import make_host_mesh

        mesh = make_host_mesh(device=dev)
    res = Sweep(specs, mesh=mesh, link=link).run(prob, x0=x0)

    rows = (res.records() if args.records
            else res.summary(target=args.target))
    if not rows or (mesh is not None and mesh.get_rank() != 0):
        return 0
    cols = list(rows[0])
    print(",".join(cols))
    for r in rows:
        print(",".join(str(r[c]) for c in cols))
    return 0


if __name__ == "__main__":
    sys.exit(main())
