"""Training driver, counterpart of ``src/repro/launch/train.py``: real
steps of ``make_train_step`` on the card (``--device cpu`` off it).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 --optimizer fednl

``--smoke`` (the default) trains the reduced config, ``--full`` the
published one. The mesh is ``make_host_mesh()`` over the ranks of the
process group (one when started alone), and each rank on its data axis
plays one FedNL silo for the curvature observations: on one card,
``n_silos`` is 1. The sharding rules give every tensor's placement on
that mesh; on one card each is replication, and laying tensors out over
several cards is ROADMAP item 10b, so a mesh of more than one rank
raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import save as save_ckpt
from ..configs import ARCHS, get_config
from ..data.tokens import TokenPipeline
from ..device import resolve_device
from ..models import build_model
from ..tree import tree_leaves
from .mesh import extents, make_host_mesh
from .sharding import opt_state_shardings, placements, tree_param_specs
from .steps import make_optimizer, make_train_step


def _require_replicated(mesh, specs) -> None:
    from torch.distributed.tensor import Replicate

    fields = specs if hasattr(specs, "_fields") else (specs,)
    for spec in (s for f in fields for s in tree_leaves(f)):
        if spec is None:
            continue
        if any(not isinstance(p, Replicate) for p in placements(mesh, spec)):
            raise NotImplementedError(
                "training over a mesh of more than one rank lays tensors out "
                "across cards: ROADMAP item 10b, not ported yet")


def train(arch: str, smoke: bool = True, steps: int = 20, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, optimizer: str = "adamw",
          microbatches: int = 1, log_every: int = 10, ckpt: str | None = None,
          seed: int = 0, refresh_every: int = 4, curvature_k: int = 2048,
          hvp: bool = False, device=None):
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    mesh = make_host_mesh(device=dev)
    ext = extents(mesh)
    if dev.type == "cuda":
        from ..kernels import build_all

        build_all()
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    _require_replicated(mesh, tree_param_specs(params, ext))

    opt_kw = {}
    if optimizer == "fednl":
        opt_kw = dict(k_per_block=curvature_k,
                      curvature="hutchinson" if hvp else "fisher")
    opt = make_optimizer(optimizer, lr, **opt_kw)
    opt_state = opt.init(params)
    # the optimizer state takes the params' own placements
    _require_replicated(mesh, opt_state_shardings(opt_state, params, ext))

    # every rank on the mesh's data axis plays one FedNL silo for the
    # curvature observations (when the batch divides across them)
    n_silos = ext.get("data", 1)
    if batch % max(n_silos, 1):
        n_silos = 1
    step_fn = make_train_step(model, opt, microbatches=microbatches,
                              refresh_every=refresh_every, n_silos=n_silos,
                              hvp=hvp, probe_seed=seed)

    # host-side wire accounting: what one curvature refresh ships
    curv_bits = (opt.uplink_bits(params, n_silos=n_silos)
                 if opt.uplink_bits is not None else 0)
    if curv_bits:
        print(f"curvature uplink: {curv_bits} bits/refresh "
              f"({n_silos} silo(s), refresh_every={refresh_every})",
              flush=True)

    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=seq,
                         global_batch=batch, seed=seed)
    history = []
    refreshes = 0
    t0 = time.time()
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             pipe.batch(i, device=dev))
        history.append(float(metrics["loss"]))
        refreshes += int(metrics["curv_refreshed"])
        if i % log_every == 0 or i == steps - 1:
            extra = (f" curv_bits {curv_bits * refreshes}"
                     if curv_bits else "")
            print(f"step {i:5d} loss {history[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}"
                  f"{extra} ({(time.time()-t0):.1f}s)", flush=True)
    if ckpt:
        save_ckpt(ckpt, {"params": params}, step=steps)
        print(f"checkpoint -> {ckpt}")
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "fednl"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--refresh-every", type=int, default=4,
                    help="curvature refresh interval (fednl): observe + "
                         "learn H every N steps, precondition every step")
    ap.add_argument("--curvature-k", type=int, default=2048,
                    help="Block-TopK k per 128x128 block for the "
                         "curvature-diff uplink (fednl)")
    ap.add_argument("--hvp", action="store_true",
                    help="Hutchinson z*(Hz) curvature probes (one "
                         "double backward per silo per refresh) instead of "
                         "the empirical-Fisher g^2 diagonal")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return train(args.arch, smoke=args.smoke, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 optimizer=args.optimizer, microbatches=args.microbatches,
                 ckpt=args.ckpt, seed=args.seed,
                 refresh_every=args.refresh_every,
                 curvature_k=args.curvature_k, hvp=args.hvp,
                 device=args.device)


if __name__ == "__main__":
    main()
