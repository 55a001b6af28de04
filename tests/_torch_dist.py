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
