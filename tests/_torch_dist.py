"""Process groups for the port's distributed tests: ``run_group`` spawns
``world`` processes joined by a gloo group over a ``FileStore`` and
returns what rank 0's task returned; ``one_rank_group`` is a one-rank
gloo group in this process, destroyed on exit.

The tasks live here, so a spawned process imports this module, torch
and the port only, never JAX.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_SECONDS = 120


def _entry(rank: int, world: int, store_path: str, out_path: str, task,
           args) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        out = task(make_host_mesh(device="cpu"), *args)
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_group(task, world: int, tmp_path, *args):
    """``task(mesh, *args)`` on every rank of a ``world``-rank gloo group
    (``mesh`` the ranks' ``make_host_mesh()``); rank 0's result."""
    store_path = str(tmp_path / "store")
    out_path = str(tmp_path / "out.pt")
    ctx = mp.start_processes(_entry, args=(world, store_path, out_path, task,
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank group did not finish in "
                                   f"{JOIN_SECONDS} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return torch.load(out_path, weights_only=False)


@contextlib.contextmanager
def one_rank_group():
    """A one-rank gloo group of this process (``make_host_mesh`` joins
    it), destroyed on exit."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- tasks (each runs on every rank; rank 0's result comes back) ----------------


def sharded_sums(mesh, values, indices, shape):
    """The sharded sum of numpy pairs, plain and symmetric, gathered;
    a window's own shape; the placements of a row-sharded spec; and the
    refusal of a d0 that does not split."""
    from repro_torch.kernels.scatter_accum.sharded import (
        sharded_scatter_accumulate,
    )
    from repro_torch.launch.sharding import placements

    v, i = torch.from_numpy(values), torch.from_numpy(indices)
    out = {sym: sharded_scatter_accumulate(v, i, shape, mesh,
                                           symmetric=sym, gather=True)
           for sym in (False, True)}
    out["window"] = tuple(sharded_scatter_accumulate(v, i, shape, mesh).shape)
    out["placements"] = [type(p).__name__ + str(getattr(p, "dim", ""))
                         for p in placements(mesh, ("data", None))]
    try:
        sharded_scatter_accumulate(v, i, (15, 16), mesh)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


def fednl_runs(mesh, a, b, lam, x0, runs, rounds):
    """``run_fednl_sharded`` of each (family, level, option) in ``runs``:
    the iterates, and this rank's silo count."""
    from repro_torch.core import make_compressor, run_fednl_sharded
    from repro_torch.interop import logreg_from_numpy

    data = logreg_from_numpy(a, b, lam, device="cpu")
    out = {}
    for family, level, option in runs:
        state, xs = run_fednl_sharded(data, make_compressor(family, level),
                                      mesh, torch.from_numpy(x0), rounds,
                                      option=option, mu=1e-3)
        out[family, option] = xs
        out["local_silos"] = int(state.h_local.shape[0])
    return out


def split_aggregates(mesh, family, level, diffs, shape):
    """Each rank compresses its silos' slice of the numpy (n, d, d)
    diffs; the server mean reduced over the ranks."""
    from repro_torch.core import FedNL, make_compressor

    comp = make_compressor(family, level)
    world = mesh.size(0)
    per = diffs.shape[0] // world
    lo = mesh.get_local_rank("data") * per
    mine = torch.from_numpy(np.ascontiguousarray(diffs[lo:lo + per]))
    method = FedNL(None, None, comp, group=mesh.get_group("data"))
    return method._server_aggregate(comp.compress(mine), shape)


# -- the train driver and the serving loop on a mesh -------------------------------


def _describe(x) -> object:
    """A leaf's placements as strings ("Shard1", "Replicate"), or its type
    name when it is no DTensor (a step count)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return [type(p).__name__ + str(getattr(p, "dim", "")) for p in
                x.placements]
    return type(x).__name__


def driver_runs(mesh, arch, overrides, argvs):
    """``driver_run`` of each argv in ``argvs`` in turn."""
    return [driver_run(mesh, arch, overrides, argv) for argv in argvs]


def driver_run(mesh, arch, overrides, argv):
    """``launch.train.main(argv)`` on this rank with ``arch``'s config
    ``.reduced(**overrides)``: every step's loss and grad_norm, the
    placements of the params' and the optimizer state's leaves, this
    rank's local bytes of them and the bytes of their replicated leaves,
    the shapes the installed ``shard_layer_params`` gathered in the first
    step, the first step's H and l gathered whole (fednl), and the final
    params gathered whole. A ``ValueError`` of the run comes back as its
    message."""
    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import whole_tree
    from repro_torch.tree import tree_leaves, tree_map

    rec = {"loss": [], "gnorm": [], "gathered": [], "error": None}
    make, constrainer = (train_mod.make_train_step,
                         train_mod.make_layer_param_constrainer)
    get = train_mod.get_config

    def recording_constrainer(mesh):
        fn = constrainer(mesh)

        def constrain(tree):
            out = fn(tree)
            if not rec["loss"]:
                for a, b in zip(tree_leaves(tree), tree_leaves(out)):
                    if a is not b:
                        rec["gathered"].append(tuple(b.shape))
            return out

        return constrain

    def recording_make(*args, **kw):
        step = make(*args, **kw)

        def run(params, opt_state, batch):
            if "params_layout" not in rec:
                def local_bytes(tree):
                    return sum(x.to_local().numel() * x.element_size()
                               for x in tree_leaves(tree)
                               if hasattr(x, "to_local"))

                def whole_bytes(tree, replicated_only=False):
                    return sum(x.numel() * x.element_size()
                               for x in tree_leaves(tree)
                               if hasattr(x, "to_local") and not (
                                   replicated_only and any(
                                       type(p).__name__ == "Shard"
                                       for p in x.placements)))

                trees = [params] + [f for f in opt_state
                                    if isinstance(f, (dict, list))]
                rec["params_layout"] = tree_map(_describe, params)
                rec["state_layout"] = {
                    f: tree_map(_describe, getattr(opt_state, f))
                    for f in opt_state._fields}
                rec["local_bytes"] = sum(local_bytes(t) for t in trees)
                rec["whole_bytes"] = sum(whole_bytes(t) for t in trees)
                rec["replicated_bytes"] = sum(whole_bytes(t, True)
                                              for t in trees)
                rec["batch_rows"] = int(batch["tokens"].shape[0])
            params, opt_state, m = step(params, opt_state, batch)
            rec["loss"].append(float(m["loss"]))
            rec["gnorm"].append(float(m["grad_norm"]))
            if len(rec["loss"]) == 1 and hasattr(opt_state, "h"):
                rec["h1"] = whole_tree(opt_state.h)
                rec["l1"] = whole_tree(opt_state.l)
            rec["params"] = params
            return params, opt_state, m

        return run

    train_mod.make_train_step = recording_make
    train_mod.make_layer_param_constrainer = recording_constrainer
    train_mod.get_config = lambda a, smoke=True: get_config(arch).reduced(
        **overrides)
    try:
        train_mod.main(list(argv))
    except ValueError as exc:
        rec["error"] = str(exc)
    finally:
        train_mod.make_train_step = make
        train_mod.make_layer_param_constrainer = constrainer
        train_mod.get_config = get
    if "params" in rec:
        rec["params"] = whole_tree(rec["params"])
    return rec


def generate_run(mesh, arch, batch, prompt_len, gen, greedy, seed):
    """``launch.serve.generate`` of the reduced ``arch`` over the mesh's
    ranks: the tokens every rank holds at the end (rank 0's come back)."""
    from repro_torch.launch.serve import generate

    return generate(arch, smoke=True, batch=batch, prompt_len=prompt_len,
                    gen=gen, seed=seed, greedy=greedy, device="cpu",
                    mesh=mesh)
