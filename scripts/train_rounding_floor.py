"""How far f32 rounding alone moves the port's reduced train step: 3
fednl steps of a reduced model on the CPU from its weights and from the
same weights times (1 + 1e-7 N(0, 1)), about one f32 step of noise.

    PYTHONPATH=src python scripts/train_rounding_floor.py \
        [--arch xlstm-350m] [--seq 300] [--batch 4]

The step is the card tests' (2 microbatches, 2 silos, a refresh every 2
steps, exact Block-Top-K k = 64 of 8 x 8 tiles, lr 1e-2). Prints, for
the parameters and the curvature H, the largest per-leaf gap over that
leaf's largest |value| and how many leaves pass 1e-4: the floor under
which no two f32 runs of the step (a card's and the CPU's) can be held.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map


def three_steps(model, params, toks):
    opt = make_optimizer("fednl", 1e-2, k_per_block=64, block=8)
    step = make_train_step(model, opt, microbatches=2, refresh_every=2,
                           n_silos=2)
    state = opt.init(params)
    for i in range(3):
        params, state, _ = step(params, state, {
            "tokens": toks[i], "targets": toks[i].roll(-1, dims=1)})
    return {"params": tree_leaves(params), "h": tree_leaves(state.h)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--seq", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (3, args.batch, args.seq),
                         generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(5)
    noisy = tree_map(lambda a: a * (1 + 1e-7 * torch.randn(
        a.shape, generator=gen)), params)
    a, b = three_steps(model, params, toks), three_steps(model, noisy, toks)
    for name in ("params", "h"):
        rel = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a[name], b[name])]
        print(f"{args.arch} B={args.batch} T={args.seq} {name}: largest "
              f"gap {max(rel):.3e} of the leaf's max; "
              f"{sum(r > 1e-4 for r in rel)} of {len(rel)} leaves over 1e-4")


if __name__ == "__main__":
    main()
