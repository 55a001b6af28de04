"""How large fednl's first preconditioned step is, tensor by tensor.

    PYTHONPATH=src python tools/fednl_step_scale.py --arch starcoder2-15b \\
        --layers 2 --lr 1e-3

trains the arch at its published width, cut to ``--layers`` layers
(``--smoke``: the reduced config), with ``make_train_step`` and no mesh
(one silo, fednl, 8 x 128 tokens, k = 2,048, a refresh every 2 steps)
for ``--steps`` steps, and reads the state after step 0. The first
refresh learns H = C(D) from H = 0 (Block-Top-K keeps k of each 128^2
tile), so an entry it did not keep still has h = 0 and steps by
g / (sqrt(l) + eps), where l is the tensor's ridge, not by
g / (sqrt(h) + sqrt(l) + eps). The momentum after step 0 is that step
itself, so |update| / lr = |mu|. Per tensor: the share of entries at
h = 0, the largest |update| / lr over those and over the others,
sqrt(l), and each step's loss. ``--optimizer adamw`` takes AdamW's
steps instead (its first step is lr times the gradient's sign on every
entry): the largest and mean |update| / lr per tensor from the params'
change (rounded to their dtype) and the losses, to set beside fednl's.
One JSON line; ``--out FILE`` writes it there too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_optimizer, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _paths(tree, prefix="params") -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def step_scale(state) -> list:
    """Per tensor of the fednl state after the first step: the share of
    entries with h = 0, max |mu| (= |update| / lr) over them and over the
    rest, and sqrt(l)."""
    out = []
    for path, h, mu, l in zip(_paths(state.h), tree_leaves(state.h),
                              tree_leaves(state.mu), tree_leaves(state.l)):
        zero = h == 0
        step = mu.abs()
        at_zero = step[zero]
        kept = step[~zero]
        out.append({
            "tensor": path, "numel": h.numel(),
            "h_zero_share": float(zero.float().mean()),
            "max_step_h_zero": float(at_zero.max()) if at_zero.numel() else 0.0,
            "max_step_h_kept": float(kept.max()) if kept.numel() else 0.0,
            "sqrt_l": float(torch.sqrt(l)),
            "steps_above_1": int((step > 1).sum())})
    return out


def param_steps(before, after, lr: float) -> list:
    """Per tensor: the largest and mean |after - before| / lr."""
    out = []
    for path, b, a in zip(_paths(before), tree_leaves(before),
                          tree_leaves(after)):
        step = (a.float() - b.float()).abs() / lr
        out.append({"tensor": path, "numel": b.numel(),
                    "max_step": float(step.max()),
                    "mean_step": float(step.mean())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-15b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--optimizer", default="fednl",
                    choices=["fednl", "adamw"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build_all

        torch.backends.cuda.matmul.allow_tf32 = False
        build_all()
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    opt = (make_optimizer("fednl", args.lr, k_per_block=args.k,
                          curvature="fisher") if args.optimizer == "fednl"
           else make_optimizer("adamw", args.lr))
    state = opt.init(params)
    step = make_train_step(model, opt, refresh_every=2, n_silos=1)
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=128, global_batch=8,
                         seed=0)
    losses, scale, t0 = [], None, time.perf_counter()
    for i in range(args.steps):
        before = params          # the step does not write its inputs
        params, state, m = step(params, state, pipe.batch(i, device=dev))
        losses.append(float(m["loss"]))
        if i == 0:
            scale = (step_scale(state) if args.optimizer == "fednl"
                     else param_steps(before, params, args.lr))
        del before
    out = {"arch": args.arch, "layers": cfg.n_layers, "lr": args.lr,
           "k": args.k, "optimizer": args.optimizer, "losses": losses,
           "seconds": time.perf_counter() - t0, "tensors": scale}
    if args.optimizer == "fednl":
        top = max(scale, key=lambda r: max(r["max_step_h_zero"],
                                           r["max_step_h_kept"]))
        out.update(largest_step_tensor=top["tensor"],
                   max_step_h_zero=max(r["max_step_h_zero"] for r in scale),
                   max_step_h_kept=max(r["max_step_h_kept"] for r in scale))
    else:
        out.update(max_step=max(r["max_step"] for r in scale))
    if dev.type == "cuda":
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    line = json.dumps({"fednl_step_scale": out})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
