"""The train driver over the ranks of ``torchrun``, held to one process.

    PYTHONPATH=src torchrun --nproc-per-node 4 tools/mesh_train_check.py

Every rank trains qwen2-0.5B at its published width through
``launch.train.train`` (fednl, 8 x 128 tokens, a refresh every 2
steps) on its own card, with the params and the fednl state laid out
over the ranks; then rank 0 runs the same steps without a mesh, one
process with ``n_silos`` = W on its card, and compares. The first
refresh's H and l must be equal bit for bit (each rank's observation
and K1 call on its own silo; the payloads stacked in silo order before
K4); each step's loss must be within ``LOSS_REL`` of one process's (the
gradient is the mean of W per-rank means in f32, cast to bf16, where one
process takes one mean: a bf16 step is 2^-8 relative). Rank 0 prints
one JSON line: the gaps, ms a step on both sides (host clock to a
synchronize), each side's peak memory, this rank's bytes of params and
state against the whole, and the card. ``--device cpu --smoke`` runs
the reduced config on gloo ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro_torch.launch.train as train_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.launch.mesh import scoped_group  # noqa: E402
from repro_torch.launch.sharding import whole_tree  # noqa: E402
from repro_torch.launch.steps import make_optimizer, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARGS = dict(batch=8, seq=128, lr=1e-3, optimizer="fednl", refresh_every=2,
            curvature_k=2048)
LOSS_REL = 1e-2


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None


def timed(step, dev: torch.device, rec: dict):
    """``step`` that records each call's host ms, loss and grad_norm, and
    the first call's params and optimizer state."""

    def run(params, opt_state, batch):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        _sync(dev)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss"].append(float(m["loss"]))
        rec["gnorm"].append(float(m["grad_norm"]))
        rec.setdefault("first", (params, opt_state))
        return params, opt_state, m

    return run


def mesh_run(arch: str, smoke: bool, steps: int, dev: torch.device) -> dict:
    """``train`` on every rank: the first refresh's H and l gathered whole
    (a collective), and this rank's bytes of params, H and momentum."""
    rec = {"ms": [], "loss": [], "gnorm": []}
    make = train_mod.make_train_step
    train_mod.make_train_step = lambda *a, **kw: timed(make(*a, **kw), dev,
                                                       rec)
    try:
        train_mod.train(arch, smoke=smoke, steps=steps, device=dev, **ARGS)
    finally:
        train_mod.make_train_step = make
    params, state = rec.pop("first")
    leaves = tree_leaves(params) + tree_leaves(state.h) + tree_leaves(state.mu)
    rec["local_bytes"] = sum(x.to_local().numel() * x.element_size()
                             for x in leaves)
    rec["whole_bytes"] = sum(x.numel() * x.element_size() for x in leaves)
    rec["h"], rec["l"] = whole_tree(state.h), whole_tree(state.l)
    return rec


def one_process(arch: str, smoke: bool, steps: int, n_silos: int,
                dev: torch.device) -> dict:
    """The same steps without a mesh, ``n_silos`` silos in one process."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    opt = make_optimizer("fednl", ARGS["lr"], k_per_block=ARGS["curvature_k"],
                         curvature="fisher")
    state = opt.init(params)
    rec = {"ms": [], "loss": [], "gnorm": []}
    step = timed(make_train_step(model, opt,
                                 refresh_every=ARGS["refresh_every"],
                                 n_silos=n_silos), dev, rec)
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=ARGS["seq"],
                         global_batch=ARGS["batch"], seed=0)
    for i in range(steps):
        params, state, _ = step(params, state, pipe.batch(i, device=dev))
    _, first = rec.pop("first")
    rec["h"], rec["l"] = first.h, first.l
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    with scoped_group():
        mesh = mesh_run(args.arch, args.smoke, args.steps, dev)
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh["peak_gb"] = _peak_gb(dev)
    if rank:
        return 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    one = one_process(args.arch, args.smoke, args.steps, world, dev)
    h_equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in
                  zip(tree_leaves(mesh["h"]), tree_leaves(one["h"])))
    l_equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in
                  zip(tree_leaves(mesh["l"]), tree_leaves(one["l"])))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["loss"],
                                                       one["loss"]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["gnorm"],
                                                        one["gnorm"]))
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    ok = h_equal and l_equal and loss_rel <= LOSS_REL
    print(json.dumps({"mesh_train_check": {
        "arch": args.arch, "smoke": args.smoke, "ranks": world,
        "steps": args.steps, **ARGS, "h_bitwise": h_equal,
        "l_bitwise": l_equal, "loss_rel_max": loss_rel,
        "gnorm_rel_max": gnorm_rel, "mesh_loss": mesh["loss"],
        "one_loss": one["loss"], "mesh_step_ms": mesh["ms"],
        "one_step_ms": one["ms"], "mesh_peak_gb": mesh["peak_gb"],
        "one_peak_gb": _peak_gb(dev), "local_bytes": mesh["local_bytes"],
        "whole_bytes": mesh["whole_bytes"], "cards": card, "ok": ok}}),
        flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
