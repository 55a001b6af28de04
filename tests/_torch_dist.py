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


def start_group(task, world: int, tmp_path, *args,
                seconds: float = JOIN_SECONDS):
    """``run_group``'s processes started, not waited for: a handle for
    ``finish_group`` (which waits ``seconds`` from now at most), so
    several groups can run at once."""
    store_path = str(tmp_path / "store")
    out_path = str(tmp_path / "out.pt")
    ctx = mp.start_processes(_entry, args=(world, store_path, out_path, task,
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_path, world, time.monotonic() + seconds


def finish_group(handle):
    """Rank 0's result of a ``start_group`` group, once every rank ended."""
    ctx, out_path, world, deadline = handle
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank group did not finish "
                                   f"in time")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return torch.load(out_path, weights_only=False)


def run_group(task, world: int, tmp_path, *args):
    """``task(mesh, *args)`` on every rank of a ``world``-rank gloo group
    (``mesh`` the ranks' ``make_host_mesh()``); rank 0's result."""
    return finish_group(start_group(task, world, tmp_path, *args))


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


def driver_run(mesh, arch, overrides, argv, config=None):
    """``launch.train.main(argv)`` on this rank with ``arch``'s config
    ``.reduced(**overrides)``: every step's loss and grad_norm, the
    placements of the params' and the optimizer state's leaves, this
    rank's local bytes of them and the bytes of their replicated leaves,
    the shapes the installed ``shard_layer_params`` gathered in the first
    step, the first step's H and l gathered whole (fednl), and the final
    params gathered whole. A ``ValueError`` of the run comes back as its
    message. ``config`` replaces the reduced config."""
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
                # copies: the driver's step writes H in place later
                rec["h1"] = tree_map(torch.clone, whole_tree(opt_state.h))
                rec["l1"] = tree_map(torch.clone, whole_tree(opt_state.l))
            rec["params"] = params
            rec.setdefault("first_params", params)
            return params, opt_state, m

        return run

    train_mod.make_train_step = recording_make
    train_mod.make_layer_param_constrainer = recording_constrainer
    train_mod.get_config = lambda a, smoke=True: (
        config or get_config(arch).reduced(**overrides))
    try:
        train_mod.main(list(argv))
    except ValueError as exc:
        rec["error"] = str(exc)
    finally:
        train_mod.make_train_step = make
        train_mod.make_layer_param_constrainer = constrainer
        train_mod.get_config = get
    if "params" in rec:
        rec["final_local"] = [x.to_local() for x in tree_leaves(rec["params"])]
        rec["params"] = whole_tree(rec["params"])
    if config is None:
        rec.pop("first_params", None)
        rec.pop("final_local", None)
    return rec


def generate_run(mesh, arch, batch, prompt_len, gen, greedy, seed):
    """``launch.serve.generate`` of the reduced ``arch`` over the mesh's
    ranks: the tokens every rank holds at the end (rank 0's come back)."""
    from repro_torch.launch.serve import generate

    return generate(arch, smoke=True, batch=batch, prompt_len=prompt_len,
                    gen=gen, seed=seed, greedy=greedy, device="cpu",
                    mesh=mesh)


# -- the "model" axis -----------------------------------------------------------------


def _config(arch, overrides, replace=None):
    """``arch``'s config ``.reduced(**overrides)``, then
    ``dataclasses.replace(**replace)`` (head counts the reduced config
    does not reach)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced(**overrides)
    return dataclasses.replace(cfg, **(replace or {}))


def _mesh2(data, model):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data, model, device="cpu")


def _model_rank_equal(x, model_axis) -> bool:
    """Whether ``x`` is bit for bit the same tensor on every rank of the
    model axis."""
    parts, = model_axis.gather(x.detach().contiguous()[None])
    return all(torch.equal(parts[0], p) for p in parts[1:])


@contextlib.contextmanager
def routes_recorded(n_layers: int):
    """A list that collects, while the block runs, the gate ids
    (groups, G, top_k) and the top-k margins (the smallest gap between
    neighbours among the k + 1 largest router probabilities, in f32: the
    pick changes at the k-th place, the order of a token's picks, its
    slot priority for the experts' capacity, above it) of the first
    ``n_layers`` MoE routings: one forward's, before remat recomputes
    them."""
    import repro_torch.models.mlp as mlp

    out, top = [], mlp.top_k_lower_index

    def recording(x, k):
        vals, ids = top(x, k)
        if len(out) < n_layers and x.shape[-1] > k:
            s = torch.sort(x.detach(), dim=-1, descending=True).values
            s = s[..., :k + 1]
            out.append({"ids": ids.detach().clone(),
                        "margin": torch.amin(s[..., :-1] - s[..., 1:], -1)})
        return vals, ids

    mlp.top_k_lower_index = recording
    try:
        yield out
    finally:
        mlp.top_k_lower_index = top


def model_axis_train(mesh, shape, runs):
    """On a ``shape`` = (data, model) mesh of this group's ranks, for each
    (arch, overrides, replace, argv) in ``runs``: ``driver_run``'s
    records of ``launch.train.main(argv)`` on that mesh, and whether
    every leaf held whole over "model" (norms, replicated biases) has
    the same first-step gradient and the same final value on each model
    rank."""
    import repro_torch.launch.train as train_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.sharding import DataAxis
    from repro_torch.tree import tree_leaves

    mesh = _mesh2(*shape)
    make_mesh, vg = train_mod.make_host_mesh, steps_mod.value_and_grad
    out = []
    for arch, overrides, replace, argv in runs:
        seen = {"routes": []}

        def recording_vg(model, params, batch, create_graph=False,
                         split_dims=None):
            with routes_recorded(model.cfg.n_layers) as routes:
                loss, leaves, grads = vg(model, params, batch, create_graph,
                                         split_dims)
            seen["routes"].append(routes)
            if "grads" not in seen:
                seen["grads"] = [g.detach() for g in grads]
            return loss, leaves, grads

        train_mod.make_host_mesh = lambda device=None: mesh
        steps_mod.value_and_grad = recording_vg
        try:
            rec = driver_run(mesh, arch, overrides, argv,
                             config=_config(arch, overrides, replace))
        finally:
            train_mod.make_host_mesh = make_mesh
            steps_mod.value_and_grad = vg
        # every data rank's groups, in one process's order (each data rank
        # routes its own rows; the model ranks route alike)
        data = DataAxis(mesh)
        rec["routes"] = [[dict(zip(("ids", "margin"), data.gather(
            r["ids"].contiguous(), r["margin"].contiguous()))) for r in call]
            for call in seen["routes"]]
        axis = DataAxis(mesh)
        first = rec.pop("first_params")
        lays = [axis.layout(x) for x in tree_leaves(first)]
        whole = [i for i, lay in enumerate(lays) if lay.mdim is None]
        rec["replicated_grads_equal"] = all(
            _model_rank_equal(seen["grads"][i], axis.model) for i in whole)
        rec["replicated_params_equal"] = all(
            _model_rank_equal(tree_leaves(rec["final_local"])[i], axis.model)
            for i in whole)
        rec["n_replicated"] = len(whole)
        rec.pop("final_local")
        out.append(rec)
    return out


def model_axis_generate(mesh, shape, cases):
    """``launch.serve.generate`` on a ``shape`` mesh for each (arch,
    overrides, replace, batch, prompt_len, gen, greedy, seed) in
    ``cases``, with the reduced config (and its ``replace``): the tokens,
    and the local shape of the first KV cache leaf this rank held."""
    import repro_torch.launch.serve as serve_mod

    mesh = _mesh2(*shape)
    get = serve_mod.get_config
    out = []
    try:
        for arch, overrides, replace, batch, prompt_len, gen, greedy, seed \
                in cases:
            serve_mod.get_config = lambda a, smoke=True: _config(
                arch, overrides, replace)
            out.append(serve_mod.generate(
                arch, smoke=True, batch=batch, prompt_len=prompt_len,
                gen=gen, seed=seed, greedy=greedy, device="cpu", mesh=mesh))
    finally:
        serve_mod.get_config = get
    return out


def model_axis_refresh(mesh, shape, arch, overrides, replace, h, obs, k):
    """One fednl refresh on a ``shape`` mesh from the whole numpy trees
    ``h`` (H) and ``obs`` (every silo's observation stacked on a leading
    axis, one silo a data index): each rank lays H out by the rules and
    takes its silo's observation, whole over "data" and its shard over
    "model". Returns H and l after the refresh gathered whole, and each
    leaf's route over "model" ("tiles": K1 on the rank's model shard;
    "gathered": the leaf gathered whole over "model" first; "whole": not
    split over it)."""
    from repro_torch.configs import model_param_shapes
    from repro_torch.launch.mesh import extents
    from repro_torch.launch.sharding import (DataAxis, from_local_tree,
                                             local_keep, local_tree,
                                             tree_param_specs, whole_tree)
    from repro_torch.second_order.fednl_precond import (FedNLPrecondOptimizer,
                                                        FedNLPrecondState,
                                                        _tile_grid)
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    mesh = _mesh2(*shape)
    ext = extents(mesh)
    cfg = _config(arch, overrides, replace)
    shapes = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                            device="meta"),
                      model_param_shapes(cfg))
    specs = tree_param_specs(shapes, ext)
    axis = DataAxis(mesh)
    paths = []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for key, val in tree.items():
                walk(val, f"{prefix}/{key}")
        elif isinstance(tree, list):
            for i, val in enumerate(tree):
                walk(val, f"{prefix}/{i}")
        else:
            paths.append(prefix)

    walk(shapes, "params")
    keep = local_keep(mesh, ext)
    keep_model = local_keep(mesh, ext, axes=("model",))
    h_t = [torch.from_numpy(x) for x in tree_leaves(h)]
    o_t = [torch.from_numpy(x) for x in tree_leaves(obs)]
    whole_shapes = [tuple(x.shape) for x in tree_leaves(shapes)]
    h_loc = [keep(p, s, x) for p, s, x in zip(paths, whole_shapes, h_t)]
    silo = axis.rank
    o_loc = [keep_model(p, s, x[silo])[None]
             for p, s, x in zip(paths, whole_shapes, o_t)]
    h_dt = from_local_tree(tree_unflatten(shapes, h_loc), mesh, specs, shapes)
    lays = tree_map(axis.layout, h_dt)
    opt = FedNLPrecondOptimizer(k_per_block=k)
    state = FedNLPrecondState(0, local_tree(h_dt), None, None)
    new = opt.refresh(state, tree_unflatten(shapes, o_loc), layout=lays)
    from repro_torch.launch.sharding import like_tree

    routes = []
    for lay, x in zip(tree_leaves(lays), h_loc):
        if lay.mdim is None or axis.model.world == 1:
            routes.append("whole")
        else:
            local = list(x.shape)
            if lay.dim is not None:
                local[lay.dim] *= axis.world
            routes.append("tiles" if _tile_grid(local, lay.mdim, opt.block)
                          is not None else "gathered")
    return {"h": whole_tree(like_tree(new.h, h_dt)),
            "l": tree_leaves(new.l), "routes": dict(zip(paths, routes))}


def model_axis_ops(mesh, shape, logits, targets, ties):
    """On a ``shape`` mesh, each model rank's vocab block of the numpy
    ``logits`` (..., V): ``vocab_parallel_cross_entropy`` and its
    gradient gathered whole, and ``argmax_over`` of each row of ``ties``
    (B, V)."""
    from repro_torch.launch.serve import argmax_over
    from repro_torch.launch.sharding import DataAxis
    from repro_torch.models.common import vocab_parallel_cross_entropy

    tp = DataAxis(_mesh2(*shape)).model
    x = tp.part(torch.from_numpy(logits), -1).clone().requires_grad_(True)
    loss = vocab_parallel_cross_entropy(x, torch.from_numpy(targets), tp)
    grad, = torch.autograd.grad(loss, x)
    return {"loss": loss.detach(), "grad": tp.whole(grad, grad.dim() - 1),
            "argmax": argmax_over(tp.part(torch.from_numpy(ties), -1), tp)}


def model_axis_cache_layout(mesh, shape, arch, overrides, replace, batch,
                            max_len):
    """The placements ``cache_specs`` gives the reduced model's cache on
    a ``shape`` mesh, as ``_describe`` strings per leaf, and this rank's
    local shape of each (``model_parts``, as ``generate`` lays it out)."""
    from repro_torch.launch.mesh import extents
    from repro_torch.launch.sharding import (DataAxis, cache_specs,
                                             model_parts, placements)
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    mesh = _mesh2(*shape)
    cache = build_model(_config(arch, overrides, replace)).init_cache(
        batch, max_len, "cpu")
    specs = cache_specs(cache, extents(mesh))
    local = model_parts(cache, specs, DataAxis(mesh).model)
    return {"placements": [
        [type(p).__name__ + str(getattr(p, "dim", ""))
         for p in placements(mesh, s)] for s in _spec_leaves(specs)],
        "local": [tuple(x.shape) for x in tree_leaves(local)]}


def _spec_leaves(specs) -> list:
    """The spec tuples of a spec tree, in ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def model_axis_tool(argv, workdir):
    """``tools/mesh_train_check.py``'s ``main(argv + ["--out", workdir])``
    on this group's ranks: its exit code and the JSON it wrote."""
    import importlib.util
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "mesh_train_check.py")
    spec = importlib.util.spec_from_file_location("mesh_train_check", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    code = tool.main(list(argv) + ["--out", workdir])
    out = None
    for name in os.listdir(workdir):
        with open(os.path.join(workdir, name)) as f:
            out = json.load(f)["mesh_train_check"]
    return {"code": code, "json": out}


def model_axis_all(mesh, shape, train_runs=(), refresh_cases=(),
                   gen_cases=(), ops=None, cache_cases=(), tool=None):
    """Every model-axis task this group runs on its ``shape`` mesh, one
    group a shape: ``model_axis_train`` of ``train_runs``,
    ``model_axis_refresh`` of each case, ``model_axis_generate``,
    ``model_axis_ops`` and ``model_axis_cache_layout``; on the same
    ranks as a (W, 1) mesh, what the hooks install there; last,
    ``model_axis_tool`` of ``tool`` (argv, workdir)."""
    from repro_torch.launch.sharding import (make_activation_constraint,
                                             make_model_axis)

    out = {"train": model_axis_train(mesh, shape, train_runs) if train_runs
           else [],
           "refresh": [model_axis_refresh(mesh, shape, *c)
                       for c in refresh_cases],
           "generate": model_axis_generate(mesh, shape, gen_cases)
           if gen_cases else [],
           "cache": [model_axis_cache_layout(mesh, shape, *c)
                     for c in cache_cases]}
    if ops is not None:
        out["ops"] = model_axis_ops(mesh, shape, *ops)
    flat = _mesh2(shape[0] * shape[1], 1)
    x = torch.zeros(2, 8, 4)
    out["flat_model_axis"] = make_model_axis(flat)
    out["flat_carry_is_identity"] = all(
        make_activation_constraint(flat)(x, kind) is x
        for kind in ("btd", "btf", "bthd", "logits", "carry"))
    if tool is not None:
        out["tool"] = model_axis_tool(*tool)
    return out


# -- the MoE family on the "model" axis, and the refresh's observation route ---------


def model_axis_logits(mesh, shape, cases, batch, t):
    """On a ``shape`` mesh, each (arch, overrides, replace)'s reduced
    model drawn with ``local_keep`` over "model" (its shards of the whole
    draw from seed 0) and run forward on a (batch, t) prompt from seed 1
    (with the family's frames or patches, ``add_modality_inputs`` of step
    0) with the model axis installed: the logits whole (gathered over the
    vocab's shards where the axis splits it) and the loss."""
    from repro_torch.launch.mesh import extents
    from repro_torch.launch.sharding import local_keep, make_model_axis
    from repro_torch.launch.train import add_modality_inputs
    from repro_torch.models import build_model
    from repro_torch.models.common import set_activation_sharder

    mesh = _mesh2(*shape)
    tp = make_model_axis(mesh)
    out = []
    for arch, overrides, replace in cases:
        cfg = _config(arch, overrides, replace)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   keep=local_keep(mesh, extents(mesh),
                                                   axes=("model",)))
        tokens = torch.randint(0, cfg.vocab, (batch, t),
                               generator=torch.Generator().manual_seed(1))
        inputs = add_modality_inputs({"tokens": tokens}, cfg, 0)
        set_activation_sharder(None, None, tp)
        try:
            with torch.no_grad():
                logits, _ = model.forward(params, inputs)
                loss = model.loss_fn(params, {**inputs, "targets":
                                              torch.roll(tokens, -1, 1)})
        finally:
            set_activation_sharder(None, None, None)
        if cfg.vocab % tp.world == 0:
            logits = tp.whole(logits.contiguous(), logits.dim() - 1)
        out.append({"logits": logits, "loss": float(loss)})
    return out


def observation_routes(mesh, shapes, cases, k):
    """For each mesh ``shapes`` entry (made on this group's ranks) and each
    (arch, overrides, replace) in ``cases``: one fednl step with a
    refresh through ``make_train_step(mesh=)`` from the same params and
    batch, once through the silos' gradients taken by the per-layer
    gather (``refresh_grads``) and once through the whole-tree route
    (the optimizer without ``refresh_grads``): H and l of each, gathered
    whole, and the number of leaves that take the layer-by-layer
    route."""
    import dataclasses

    from repro_torch.configs import model_param_shapes
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import extents
    from repro_torch.launch.sharding import (DataAxis, from_local_tree,
                                             local_keep, local_tree,
                                             make_activation_constraint,
                                             make_layer_param_constrainer,
                                             make_model_axis,
                                             opt_state_shardings,
                                             tree_param_specs, whole_tree)
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import set_activation_sharder
    from repro_torch.tree import tree_leaves, tree_map

    out = []
    for shape in shapes:
        m = _mesh2(*shape)
        ext, axis = extents(m), DataAxis(m)
        for arch, overrides, replace in cases:
            cfg = _config(arch, overrides, replace)
            model = build_model(cfg)
            opt = make_optimizer("fednl", 2e-3, k_per_block=k)
            meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                  device="meta"),
                            model_param_shapes(cfg))
            rec = {"shape": shape, "arch": arch}
            for name, o in (("grads", opt),
                            ("whole", dataclasses.replace(
                                opt, refresh_grads=None))):
                params = model.init_params(torch.Generator().manual_seed(0),
                                           keep=local_keep(m, ext))
                state, state_meta = o.init(params), o.init(meta)
                state = from_local_tree(state, m, opt_state_shardings(
                    state_meta, meta, ext), state_meta)
                params = from_local_tree(params, m,
                                         tree_param_specs(meta, ext), meta)
                step = make_train_step(model, o, refresh_every=1,
                                       n_silos=axis.world, mesh=m)
                rows = 8 // axis.world
                batch = tree_map(
                    lambda x: x[axis.rank * rows:(axis.rank + 1) * rows],
                    TokenPipeline(vocab_size=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=0).batch(0, "cpu"))
                set_activation_sharder(make_activation_constraint(m),
                                       make_layer_param_constrainer(m),
                                       make_model_axis(m))
                try:
                    _, new, _ = step(params, state, batch)
                finally:
                    set_activation_sharder(None, None, None)
                rec[name] = {"h": whole_tree(new.h), "l": whole_tree(new.l)}
            learner = opt.refresh_grads.__self__
            rec["layered"] = sum(
                learner._by_layer(h, axis.layout(p)) is not None
                for h, p in zip(tree_leaves(local_tree(new.h)),
                                tree_leaves(params)))
            out.append(rec)
    return out


def moe_axis_all(mesh, shape, logits, observe, rest: dict):
    """``model_axis_all(mesh, shape, **rest)`` with, first,
    ``model_axis_logits`` of ``logits`` (cases, batch, t) and
    ``observation_routes`` of ``observe`` (shapes, cases, k), each
    skipped where None."""
    out = {}
    if logits is not None:
        out["logits"] = model_axis_logits(mesh, shape, *logits)
    if observe is not None:
        out["observe"] = observation_routes(mesh, *observe)
    out.update(model_axis_all(mesh, shape, **rest))
    return out


# -- xLSTM, the encoder-decoder and the VLM on the "model" axis ----------------------


def model_axis_generate_states(mesh, shape, cases):
    """``model_axis_generate`` of ``cases`` with each run's cache kept:
    the tokens, and for every cache leaf this rank holds whole (its local
    shape the whole cache's: an mLSTM's n and m, an sLSTM's state, the
    encoder's memory, a KV cache that does not split), its path and
    whether it is bit for bit the same on every model rank after the
    decode."""
    import repro_torch.launch.serve as serve_mod
    from repro_torch.launch.sharding import DataAxis

    tp = DataAxis(_mesh2(*shape)).model
    make, caches = serve_mod.make_serve_step, []

    def recording(model):
        step = make(model)

        def run(params, cache, token, pos):
            if not caches or caches[-1][0] is not cache:
                caches.append((cache, model))
            return step(params, cache, token, pos)

        return run

    serve_mod.make_serve_step = recording
    try:
        tokens = model_axis_generate(mesh, shape, cases)
    finally:
        serve_mod.make_serve_step = make
    out = []
    for seqs, (cache, model), case in zip(tokens, caches, cases):
        batch, prompt_len, gen = case[3:6]
        whole = model.init_cache(batch, prompt_len + gen, "cpu")
        equal = {}
        for j, (got, want) in enumerate(zip(cache["blocks"],
                                            whole["blocks"])):
            for name, x in got.items():
                if tuple(x.shape) == tuple(want[name].shape):
                    equal[f"blocks/{j}/{name}"] = _model_rank_equal(x, tp)
        if "enc" in cache:
            equal["enc"] = _model_rank_equal(cache["enc"], tp)
        out.append({"tokens": seqs, "whole_equal": equal})
    return out


def ssm_axis_all(mesh, shape, logits, rest: dict, gen_cases=()):
    """``moe_axis_all(mesh, shape, logits, None, rest)``, then
    ``model_axis_generate_states`` of ``gen_cases``."""
    out = moe_axis_all(mesh, shape, logits, None, rest)
    out["generate"] = (model_axis_generate_states(mesh, shape, gen_cases)
                       if gen_cases else [])
    return out


# -- Hutchinson curvature over the "model" axis ------------------------------------


@contextlib.contextmanager
def contiguous_collectives():
    """While the block runs, every axis primitive refuses a tensor that is
    not contiguous, as NCCL does (gloo on the host takes any dense one)."""
    from repro_torch.launch import sharding

    names = ("_all_gather", "_all_reduce", "_reduce_scatter")
    saved = {n: getattr(sharding._Axis, n) for n in names}

    def checked(fn):
        def call(self, x, *args):
            if not x.is_contiguous():
                raise ValueError("Tensors must be contiguous")
            return fn(self, x, *args)
        return call

    for n in names:
        setattr(sharding._Axis, n, checked(saved[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(sharding._Axis, n, saved[n])


def _rank_stack(axis, x):
    """Every rank's ``x`` stacked (data, model, *x.shape) in rank order."""
    over_model, = axis.model.gather(x.detach().contiguous()[None])
    over_data, = axis.gather(over_model[None])
    return over_data


def hvp_axis_train(mesh, shape, runs, tool=None):
    """On a ``shape`` mesh, for each (arch, overrides, replace, argv) in
    ``runs`` (argv with ``--hvp``), under "runs": ``driver_run``'s records of
    ``launch.train.main(argv)``, and of the first refresh's double
    backward (``launch.steps.grad_and_hvp``, one silo a data rank) every
    rank's z, Hz and z * Hz of each leaf stacked (data, model, *the
    rank's shape) in rank order (``_rank_stack``), each leaf's "model"
    dim (None: held whole), and whether each leaf held whole over
    "model" has the same Hz on every model rank (the primitives refuse a
    tensor that is not contiguous, as NCCL does:
    ``contiguous_collectives``); then under "tool",
    ``model_axis_tool`` of ``tool`` (argv, workdir), None without."""
    import repro_torch.launch.train as train_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.sharding import DataAxis
    from repro_torch.tree import tree_leaves

    mesh = _mesh2(*shape)
    axis = DataAxis(mesh)
    make_mesh, hvp = train_mod.make_host_mesh, steps_mod.grad_and_hvp
    out = []
    for arch, overrides, replace, argv in runs:
        seen = {}

        def recording(model, params, batch, z):
            g, hz = hvp(model, params, batch, z)
            if "hz" not in seen:
                seen["z"], seen["hz"] = tree_leaves(z), tree_leaves(hz)
            return g, hz

        train_mod.make_host_mesh = lambda device=None: mesh
        steps_mod.grad_and_hvp = recording
        try:
            with contiguous_collectives():
                rec = driver_run(mesh, arch, overrides, argv,
                                 config=_config(arch, overrides, replace))
        finally:
            train_mod.make_host_mesh = make_mesh
            steps_mod.grad_and_hvp = hvp
        lays = [axis.layout(x) for x in tree_leaves(rec.pop("first_params"))]
        rec.pop("final_local")
        rec["mdims"] = [lay.mdim for lay in lays]
        rec["z"] = [_rank_stack(axis, x) for x in seen["z"]]
        rec["hz"] = [_rank_stack(axis, x) for x in seen["hz"]]
        rec["obs"] = [_rank_stack(axis, z.float() * h.float())
                      for z, h in zip(seen["z"], seen["hz"])]
        rec["whole_hz_equal"] = all(
            _model_rank_equal(h, axis.model)
            for h, lay in zip(seen["hz"], lays) if lay.mdim is None)
        out.append(rec)
    return {"runs": out,
            "tool": None if tool is None else model_axis_tool(*tool)}


def hvp_op_function(tp, name: str, targets=None):
    """The ``name`` case of ``HVP_OP_CASES`` as this rank computes it over
    the model axis ``tp``: a function of tensors held whole on every rank
    to a tensor held whole on every rank, through the operators the case
    names (each rank's own constant ``c``, 0.7 or -1.3 and on, where its
    ranks compute apart)."""
    import torch
    from repro_torch.launch.sharding import _SumPart
    from repro_torch.models.common import vocab_parallel_cross_entropy

    c = (0.7, -1.3, 0.4, 1.1)[tp.rank]
    if name == "copy_in_reduce_out":
        return lambda x, w1, w2: tp.reduce_out(torch.tanh(
            tp.copy_in(x) @ tp.split_on(w1, 1)) @ tp.split_on(w2, 0))
    if name == "split_on_gather_on":
        return lambda x, w: tp.gather_on(torch.tanh(
            tp.copy_in(x) @ tp.split_on(w, 1)), 1)
    if name == "gather_weight":
        return lambda x, w: tp.gather_on(torch.tanh(
            tp.split_on(x, 0) @ tp.gather_weight(tp.split_on(w, 1), 1)), 0)
    if name == "sum_part":
        return lambda x: tp.gather_on(_SumPart.apply(
            torch.tanh(c * tp.copy_in(x)), tp, 0), 0)
    if name == "vocab_parallel_cross_entropy":
        return lambda logits: vocab_parallel_cross_entropy(
            tp.split_on(logits, -1), targets, tp)
    raise ValueError(name)


def hvp_ops(mesh, cases):
    """For each (name, inputs, u, v, targets) in ``cases`` (numpy f64),
    on the model axis of this group's ranks as a (1, W) mesh:
    ``torch.autograd.gradgradcheck`` of ``hvp_op_function`` at
    ``inputs`` with the output gradient ``u`` (the same on every rank),
    and its value, its gradient g (the vector-Jacobian product with
    ``u``) and the double backward of g's product with ``v``; whether
    each of those is the same on every rank. The primitives refuse a
    tensor that is not contiguous, as NCCL does
    (``contiguous_collectives``)."""
    from repro_torch.launch.sharding import DataAxis

    tp = DataAxis(_mesh2(1, dist.get_world_size())).model
    out = {}
    with contiguous_collectives():
        for name, inputs, u, v, targets in cases:
            out[name] = _hvp_op_case(tp, name, inputs, u, v, targets)
    return out


def _hvp_op_case(tp, name, inputs, u, v, targets) -> dict:
    """One case of ``hvp_ops``."""
    import torch

    fn = hvp_op_function(tp, name, None if targets is None
                         else torch.from_numpy(targets))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    u_t = torch.from_numpy(u)
    ok = torch.autograd.gradgradcheck(fn, xs, grad_outputs=[u_t])
    y = fn(*xs)
    g = torch.autograd.grad(y, xs, grad_outputs=u_t, create_graph=True)
    hv = torch.autograd.grad(g, xs, grad_outputs=[torch.from_numpy(w)
                                                  for w in v])
    rec = {"gradgradcheck": ok, "y": y.detach(),
           "g": [x.detach() for x in g], "hv": list(hv)}
    rec["ranks_equal"] = all(
        _model_rank_equal(x, tp)
        for x in [rec["y"].reshape(-1)] + rec["g"] + rec["hv"])
    return rec
