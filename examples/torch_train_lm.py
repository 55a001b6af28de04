"""End-to-end LM training on the PyTorch port: a qwen2-family
model trained for a few hundred steps with either AdamW or the
paper-derived FedNL structured-curvature preconditioner (--optimizer
fednl). Runs on the card unless given ``--device cpu``.

Defaults are sized for a quick run (a ~15M-param reduced config, 200
steps). `--full` selects the real qwen2-0.5b config — the same script,
pointed at the H100, is the production path the dry run proves out.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 --optimizer fednl

Second-order walkthrough (--optimizer fednl): the train step splits the
global batch over the mesh data axis — each rank plays one FedNL silo
(one silo on one card). Every --refresh-every steps (intermediate steps
pay nothing) each silo takes a local curvature observation — the
empirical-Fisher g^2 diagonal, or a Hutchinson z*(Hz) probe with --hvp —
compresses the diff against the shared estimate H through the fused
Block-TopK payload kernel (--curvature-k values per 128x128 block, the
paper's C(D - H) uplink), and H learns from the payload-space server
mean through the block scatter-add kernel: H <- H + alpha*C(D - H), with
the Option-2 ridge l = ||D - H||_F making sqrt(H) + sqrt(l) a safe
diagonal preconditioner. All other steps just apply that stored
preconditioner — per-step cost is elementwise, and ``train`` logs the
uplink cost as curv_bits next to loss/gnorm.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.mesh import scoped_group
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "fednl"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--refresh-every", type=int, default=4)
    ap.add_argument("--curvature-k", type=int, default=2048)
    ap.add_argument("--hvp", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # train's mesh joins the process group there is, or makes a one-rank
    # group, which is destroyed when training ends
    with scoped_group():
        hist = train(args.arch, smoke=not args.full, steps=args.steps,
                     batch=args.batch, seq=args.seq, lr=args.lr,
                     optimizer=args.optimizer, ckpt=args.ckpt,
                     refresh_every=args.refresh_every,
                     curvature_k=args.curvature_k, hvp=args.hvp,
                     device=args.device)
    print(f"\nloss: {hist[0]:.3f} -> {hist[-1]:.3f} over {args.steps} steps "
          f"({args.optimizer})")
    return hist


if __name__ == "__main__":
    main()
