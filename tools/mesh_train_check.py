"""The train driver and ``generate`` over the ranks of ``torchrun``, on a
("data", "model") mesh, held to one process or to another run.

    PYTHONPATH=src torchrun --nproc-per-node 4 tools/mesh_train_check.py \\
        --arch qwen2-0.5b --data 2 --model 2

Every rank trains the arch at its published width (``--smoke``: the
reduced one) through ``launch.train.train(mesh=make_host_mesh(data,
model))`` (fednl, 8 x 128 tokens, a refresh every 2 steps) on its own
card, the params and the fednl state laid out by the rules: split over
"model" every family computes tensor-parallel (an MoE expert parallel
where its experts divide the extent, else inside each expert; MLA on its
heads; a Mamba mixer on its channels; an mLSTM on its heads, an sLSTM's
recurrence on every rank; whisper's encoder and cross-attention on their
heads), and each index of "data" is one FedNL silo, whose observation
goes through the per-layer gather. ``train``'s step donates its inputs
(H, the momentum and the params are updated in place), so one copy of
the state is alive. ``--layers N`` cuts the depth (the width stays
published; a hybrid stack below one period keeps its first N layers,
jamba's 1 and 2 are Mamba + MLP and Mamba + MoE; whisper's decoder) and
``--lr`` sets the step size. A VLM's batch holds its patches before the
128 text tokens (llava-next-34b: 2,880 + 128), an encoder-decoder's its
frames (``launch.train.add_modality_inputs``, on both sides). Then,
where one card holds the arch's fednl state (the weights, H and momentum
are under half its memory), rank 0 runs the same steps without a mesh,
one process with ``n_silos`` = the data extent, and compares: each
step's loss within ``LOSS_REL``, and on a model axis of one rank the
first refresh's H and l bit for bit (each rank's K1 on its silo, the
payloads stacked in silo order before K4). Over a wider model axis the
silo's observation comes through the tensor-parallel layers, whose
row-parallel sums round apart from one product's, so H's gap is reported
(the refresh itself, handed the same observations, is held bit for bit
by ``tests/test_torch_model_axis.py`` and ``chip_smoke.py`` phase 16).
With ``--spread``, a third run on rank 0, from the weights changed by
one rounding (``tree.nudged``), gives the one card's own spread of the
losses and grad norms, reported beside the mesh's gaps. Where no card
holds it (starcoder2-15b: 31.9 GB of weights and 127.6 GB of f32 H and
momentum), or where the twin runs out of memory (reported
as ``one_out_of_memory``), there is no twin: every loss must be finite,
and ``--against FILE`` holds each step's loss within ``LOSS_REL`` of the
run whose JSON is in FILE (another mesh's run of the same arch).

``--serve``: ``make_prefill`` over the mesh at T = ``--prompt`` tokens
(K9 on each rank's heads; a VLM's patches before them, an
encoder-decoder's frames beside), the logits gathered over the vocab's
shards, then ``generate(mesh=)`` of ``--gen`` greedy tokens after a
32-token prompt; rank 0 then does both on its card alone, with the same
draws, and compares: the tokens equal and the prefill's logits within
1e-4 of the largest. A third prefill on rank 0, from the weights changed
by one rounding (``tree.nudged``), gives the one card's own spread,
reported beside the gap; for xLSTM (family ``ssm``), whose mLSTM
normalizer answers such a change by far more than 1e-4 at depth, the
bound is the larger of 1e-4 and ``tree.SPREAD_FACTOR`` times that spread
(``--serve`` runs the config in f32 unless ``--dtype`` says otherwise; in
training ``--dtype`` replaces the config's type). Where one
card cannot hold the weights twice (llava-next-34b whole: 68.8 GB in
bf16), there is no twin: the logits must be finite and the tokens inside
the vocab. For an MoE, the prefill's routing is compared token by token:
where a token's experts (or their order) flip at a router near tie
(``NEAR_TIE``), its layer's output changes and attention carries it on,
so the logits' gap is reported and the first flip must be a near tie
instead. A second prefill on each side times the routing
(``mlp.route_groups``) and gives its share. Each step's peak memory is
recorded on both sides.

Rank 0 prints one JSON line, and with ``--out DIR`` writes it to
``DIR/<arch>[_L<layers>][_lr<lr>][_<dtype>]_<data>x<model>[_serve].json``:
the gaps, ms a step or a token on both sides (host clock to a synchronize), peak memory, this
rank's bytes of params and state against the whole, and the card.
``--device cpu --smoke`` runs on gloo ranks.

``--hvp``: the fednl steps take Hutchinson curvature (z * Hz, a double
backward through the tensor-parallel layers on each model rank) instead
of the empirical Fisher's, on both sides, with the same probes (one
process's z, each rank its block of it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro_torch.launch.serve as serve_mod  # noqa: E402
import repro_torch.launch.train as train_mod  # noqa: E402
import repro_torch.models.mlp as mlp  # noqa: E402
from repro_torch.configs import get_config, model_param_shapes  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import LAUNCHES, ROUTES, build_all  # noqa: E402
from repro_torch.launch.mesh import (extents, make_host_mesh,  # noqa: E402
                                     scoped_group)
from repro_torch.launch.sharding import (DataAxis, local_keep,  # noqa: E402
                                         make_model_axis, whole_tree)
from repro_torch.launch.steps import (make_optimizer,  # noqa: E402
                                      make_prefill, make_train_step)
from repro_torch.launch.train import add_modality_inputs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import set_activation_sharder  # noqa: E402
from repro_torch.tree import (SPREAD_FACTOR, nudged,  # noqa: E402
                              tree_leaves, tree_map)

ARGS = dict(batch=8, seq=128, lr=1e-3, optimizer="fednl", refresh_every=2,
            curvature_k=2048)
LOSS_REL = 1e-2
LOGIT_REL = 1e-4
NEAR_TIE = 1e-5
SERVE_PROMPT = 32


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None


def _card(dev: torch.device):
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()


def _config(args, **fields):
    """The arch's config (``--smoke``: reduced), its depth cut to
    ``--layers`` and its type set to ``--dtype`` where given, with
    ``fields`` replaced."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        fields["n_layers"] = args.layers
    if args.dtype:
        fields.setdefault("dtype", args.dtype)
    return dataclasses.replace(cfg, **fields)


def _serve_dtype(args) -> str:
    return args.dtype or "float32"


def _train_args(args) -> dict:
    """``train``'s arguments: a VLM's sequence is its patches and then
    ``ARGS``'s text tokens."""
    cfg = _config(args)
    extra = cfg.vision_tokens if cfg.family == "vlm" else 0
    return dict(ARGS, lr=args.lr, seq=ARGS["seq"] + extra, hvp=args.hvp)


def _state_bytes(args) -> int:
    """Bytes of the arch's weights, f32 H and f32 momentum, whole."""
    cfg = _config(args)
    return sum(math.prod(s.shape) * (s.dtype.itemsize + 8)
               for s in tree_leaves(model_param_shapes(cfg)))


def timed(step, dev: torch.device, rec: dict, keep_first: bool):
    """``step`` that records each call's host ms, loss and grad_norm, and
    (``keep_first``) the first call's H and l gathered whole."""

    def run(params, opt_state, batch):
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        _sync(dev)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["step_peak_gb"].append(_peak_gb(dev))
        rec["loss"].append(float(m["loss"]))
        rec["gnorm"].append(float(m["grad_norm"]))
        rec["refreshed"].append(bool(m["curv_refreshed"]))
        leaves = (tree_leaves(params) + tree_leaves(opt_state.h)
                  + tree_leaves(opt_state.mu))
        if "bytes" not in rec and hasattr(leaves[0], "to_local"):
            rec["bytes"] = (
                sum(x.to_local().numel() * x.element_size() for x in leaves),
                sum(x.numel() * x.element_size() for x in leaves))
            if keep_first:       # copies: the next steps write H in place
                rec["h"], rec["l"] = (
                    tree_map(torch.clone, whole_tree(opt_state.h)),
                    tree_map(torch.clone, whole_tree(opt_state.l)))
        return params, opt_state, m

    return run


def mesh_run(args, mesh, dev: torch.device, keep_first: bool) -> dict:
    """``train`` on every rank of ``mesh`` (its step donates its
    inputs)."""
    rec = {"ms": [], "loss": [], "gnorm": [], "refreshed": [],
           "step_peak_gb": []}
    make, get = train_mod.make_train_step, train_mod.get_config
    train_mod.make_train_step = lambda *a, **kw: timed(
        make(*a, **kw), dev, rec, keep_first)
    train_mod.get_config = lambda a, smoke=True: _config(args)
    try:
        train_mod.train(args.arch, smoke=args.smoke, steps=args.steps,
                        device=dev, mesh=mesh, **_train_args(args))
    finally:
        train_mod.make_train_step, train_mod.get_config = make, get
    return rec


def one_process(args, n_silos: int, dev: torch.device,
                nudge: bool = False) -> dict:
    """The same steps without a mesh, ``n_silos`` silos in one process;
    ``nudge``: from the weights ``tree.nudged`` (seed 11)."""
    cfg = _config(args)
    model = build_model(cfg, use_remat=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if nudge:
        params = nudged(params, torch.Generator(device=dev).manual_seed(11))
    opt = make_optimizer("fednl", args.lr, k_per_block=ARGS["curvature_k"],
                         curvature="hutchinson" if args.hvp else "fisher")
    state = opt.init(params)
    rec = {"ms": [], "loss": [], "gnorm": [], "refreshed": [],
           "step_peak_gb": []}
    first = {}

    def keep(step):
        def run(p, s, b):
            p, s, m = step(p, s, b)
            first.setdefault("h", (s.h, s.l))
            return p, s, m
        return run

    step = keep(timed(make_train_step(model, opt,
                                      refresh_every=ARGS["refresh_every"],
                                      n_silos=n_silos, hvp=args.hvp),
                      dev, rec, False))
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=ARGS["seq"],
                         global_batch=ARGS["batch"], seed=0)
    for i in range(args.steps):
        batch = add_modality_inputs(pipe.batch(i, device=dev), cfg, i)
        params, state, _ = step(params, state, batch)
    rec["h"], rec["l"] = first["h"]
    return rec


def _rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _spread(args, data: int, dev: torch.device, one: dict, out: dict):
    """The one card's own spread into ``out``: its run from the weights
    ``tree.nudged`` against ``one``, its run (whose H is freed first)."""
    one.pop("h"), one.pop("l")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        moved = one_process(args, data, dev, nudge=True)
        out.update(spread_loss_rel_max=_rel(moved["loss"], one["loss"]),
                   spread_gnorm_rel_max=_rel(moved["gnorm"], one["gnorm"]))
    except torch.OutOfMemoryError as exc:
        out["spread_out_of_memory"] = str(exc).splitlines()[0]
        torch.cuda.empty_cache()


def train_check(args, dev: torch.device) -> dict:
    twin = (dev.type != "cuda" or 2 * _state_bytes(args)
            < torch.cuda.get_device_properties(dev).total_memory)
    with scoped_group():
        mesh = make_host_mesh(args.data, args.model, device=dev)
        data = DataAxis(mesh).world
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec = mesh_run(args, mesh, dev, twin)
        rank = dist.get_rank()
        rec["peak_gb"] = (max(rec["step_peak_gb"]) if dev.type == "cuda"
                          else None)
    if rank:
        return {}
    out = {"arch": args.arch, "smoke": args.smoke, "layers": args.layers,
           "dtype": _config(args).dtype,
           "mesh": extents(mesh), "steps": args.steps, **_train_args(args),
           "mesh_loss": rec["loss"],
           "mesh_gnorm": rec["gnorm"], "mesh_step_ms": rec["ms"],
           "refreshed": rec["refreshed"], "mesh_peak_gb": rec["peak_gb"],
           "mesh_step_peak_gb": rec["step_peak_gb"],
           "local_bytes": rec["bytes"][0], "whole_bytes": rec["bytes"][1],
           "losses_finite": all(math.isfinite(x) for x in rec["loss"])}
    ok = out["losses_finite"]
    one = None
    if twin:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            one = one_process(args, data, dev)
        except torch.OutOfMemoryError as exc:
            # the twin's state is under half the card, its step's
            # temporaries not: reported, and the run held as one no card
            # holds
            out["one_out_of_memory"] = str(exc).splitlines()[0]
            torch.cuda.empty_cache()
    if one is not None:
        out["h_bitwise"] = all(
            torch.equal(a.cpu(), b.cpu()) for a, b in
            zip(tree_leaves(rec["h"]), tree_leaves(one["h"])))
        out["l_bitwise"] = all(
            torch.equal(a.cpu(), b.cpu()) for a, b in
            zip(tree_leaves(rec["l"]), tree_leaves(one["l"])))
        out["h_rel_max"] = max(
            float((a.cpu() - b.cpu()).abs().max())
            / max(float(b.abs().max()), 1e-30)
            for a, b in zip(tree_leaves(rec["h"]), tree_leaves(one["h"])))
        out.update(one_loss=one["loss"], one_gnorm=one["gnorm"],
                   one_step_ms=one["ms"],
                   one_peak_gb=_peak_gb(dev),
                   one_step_peak_gb=one["step_peak_gb"],
                   loss_rel_max=_rel(rec["loss"], one["loss"]),
                   gnorm_rel_max=_rel(rec["gnorm"], one["gnorm"]))
        if args.spread:
            _spread(args, data, dev, one, out)
        ok = ok and out["loss_rel_max"] <= LOSS_REL
        if args.model == 1:
            ok = ok and out["h_bitwise"] and out["l_bitwise"]
    if args.against:
        with open(args.against) as f:
            other = json.load(f)["mesh_train_check"]
        out["against"] = {"mesh": other["mesh"],
                          "loss_rel_max": _rel(rec["loss"],
                                               other["mesh_loss"])}
        ok = ok and out["against"]["loss_rel_max"] <= LOSS_REL
    out["ok"] = ok
    return out


def _prefill(args, t: int, dev: torch.device, mesh, nudge: bool = False):
    """``make_prefill`` of one (1, t) prompt drawn as ``generate`` draws
    it (the weights, then the prompt, from one seeded generator), on
    this rank's shards over ``mesh``'s model axis (None: on the card
    alone): the logits gathered whole, host ms, K9's launches. ``nudge``:
    the weights ``tree.nudged`` (seed 11) after the draws, a change of
    one rounding's size in their type."""
    cfg = _config(args, dtype=_serve_dtype(args))
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    tp = None if mesh is None else make_model_axis(mesh)
    keep = None if tp is None else local_keep(mesh, extents(mesh),
                                              axes=("model",))
    params = model.init_params(g, keep=keep)
    tokens = torch.randint(0, cfg.vocab, (1, t), generator=g, device=dev)
    batch = add_modality_inputs({"tokens": tokens}, cfg, 0)
    if nudge:
        params = nudged(params, torch.Generator(device=dev).manual_seed(11))
    set_activation_sharder(None, None, tp)
    routes, top = [], mlp.top_k_lower_index

    def recording(x, k):
        vals, ids = top(x, k)
        s = torch.sort(x, dim=-1, descending=True).values[..., :k + 1]
        routes.append((ids.cpu(), torch.amin(s[..., :-1] - s[..., 1:],
                                              dim=-1).cpu()))
        return vals, ids

    try:
        prefill = make_prefill(model)
        prefill(params, {**batch, "tokens": tokens[:, :16]})  # warm-up
        _sync(dev)
        before = LAUNCHES["flash_attention"]
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        mlp.top_k_lower_index = recording
        prefill(params, batch)
    finally:
        mlp.top_k_lower_index = top
        set_activation_sharder(None, None, None)
    launches = LAUNCHES["flash_attention"] - before
    route = _route_share(prefill, params, batch, tp, dev) \
        if cfg.moe is not None else None
    last = logits[:, -1]
    if tp is not None and cfg.vocab % tp.world == 0:
        last = tp.whole(last.contiguous(), last.dim() - 1)
    return last.float().cpu(), ms, launches, route, routes


def _route_share(prefill, params, batch, tp, dev) -> dict:
    """The MoE routing's share of one prefill: a second prefill with
    ``mlp.route_groups`` (the replicated router and ``_route``) timed by
    the host clock between synchronizes, against the prefill's own ms
    in that pass."""
    spent = []
    route = mlp.route_groups

    def timed(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = route(*a, **kw)
        _sync(dev)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    mlp.route_groups = timed
    set_activation_sharder(None, None, tp)
    try:
        _sync(dev)
        t0 = time.perf_counter()
        prefill(params, batch)
        _sync(dev)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        mlp.route_groups = route
        set_activation_sharder(None, None, None)
    return {"route_ms": sum(spent), "prefill_ms": total,
            "share": sum(spent) / total, "routings": len(spent)}


def _generate(args, dev: torch.device, mesh):
    """``generate`` of ``--gen`` greedy tokens after a ``SERVE_PROMPT``
    prompt in ``--dtype``, with each serve step timed: (tokens, ms a
    decode step)."""
    cfg = _config(args, dtype=_serve_dtype(args))
    times = []
    make, get = serve_mod.make_serve_step, serve_mod.get_config

    def timed_serve(model):
        step = make(model)

        def run(*a):
            _sync(dev)
            t0 = time.perf_counter()
            out = step(*a)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return run

    serve_mod.make_serve_step = timed_serve
    serve_mod.get_config = lambda a, smoke=True: cfg
    try:
        seqs = serve_mod.generate(args.arch, smoke=args.smoke, batch=1,
                                  prompt_len=SERVE_PROMPT, gen=args.gen,
                                  seed=0, greedy=True, device=dev, mesh=mesh)
    finally:
        serve_mod.make_serve_step, serve_mod.get_config = make, get
    return seqs.cpu(), times[SERVE_PROMPT:]


def _flips(one: list, mesh: list) -> dict:
    """Tokens whose top-k experts (or their order) differ between one
    card's routings and rank 0's over the mesh, layer by layer: how many,
    the first layer with any, and one card's largest top-k margin there
    (the smallest gap between neighbours among the k + 1 largest router
    probabilities)."""
    tokens, first, margin = 0, None, 0.0
    for i, ((ids, gaps), (m_ids, _)) in enumerate(zip(one, mesh)):
        differ = (ids != m_ids).any(-1)
        tokens += int(differ.sum())
        if first is None and bool(differ.any()):
            first, margin = i, float(gaps[differ].max())
    return {"tokens": tokens, "first_layer": first, "first_margin": margin}


def _weight_bytes(args) -> int:
    """Bytes of the arch's weights, whole, in ``--dtype``."""
    size = torch.empty((), dtype=getattr(torch, _serve_dtype(args))
                       ).element_size()
    return sum(math.prod(s.shape) * size
               for s in tree_leaves(model_param_shapes(_config(args))))


def serve_check(args, dev: torch.device) -> dict:
    twin = (dev.type != "cuda" or 2 * _weight_bytes(args)
            < torch.cuda.get_device_properties(dev).total_memory)
    with scoped_group():
        mesh = make_host_mesh(args.data, args.model, device=dev)
        logits, ms, k9, route, routes = _prefill(args, args.prompt, dev,
                                                 mesh)
        seqs, tok_ms = _generate(args, dev, mesh)
        rank = dist.get_rank()
        peak = _peak_gb(dev)
        ext = extents(mesh)
    if rank:
        return {}
    out = {"arch": args.arch, "smoke": args.smoke, "layers": args.layers,
           "mesh": ext, "dtype": _serve_dtype(args), "prefill_t": args.prompt,
           "gen": args.gen, "prompt": SERVE_PROMPT, "mesh_prefill_ms": ms,
           "k9_launches_rank0": k9,
           "mesh_ms_per_token": tok_ms, "mesh_peak_gb": peak,
           "mesh_routing_rank0": route,
           "logits_finite": bool(torch.isfinite(logits).all()),
           "tokens": seqs[0, SERVE_PROMPT:].tolist()}
    if not twin:
        # no card holds the weights twice: the run is held to finite
        # logits and tokens inside the vocab
        out["k9_routes"] = dict(ROUTES.get("flash_attention", {}))
        out["ok"] = out["logits_finite"] and bool(
            ((seqs >= 0) & (seqs < _config(args).vocab)).all())
        return out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    one_logits, one_ms, one_k9, one_route, one_routes = _prefill(
        args, args.prompt, dev, None)
    one_seqs, one_tok_ms = _generate(args, dev, None)
    gap = float((logits - one_logits).abs().max())
    top = float(one_logits.abs().max())
    # the one card's own spread under a rounding-sized change of its
    # weights, reported; xLSTM's bound is the larger of LOGIT_REL and
    # SPREAD_FACTOR times it (its mLSTM normalizer answers such a change
    # by far more than 1e-4 at depth), every other family's LOGIT_REL
    moved = _prefill(args, args.prompt, dev, None, nudge=True)[0]
    floor = float((moved - one_logits).abs().max()) / top
    rel = (max(LOGIT_REL, SPREAD_FACTOR * floor)
           if _config(args).family == "ssm" else LOGIT_REL)
    bound = rel * top
    out.update({"one_prefill_ms": one_ms, "k9_launches_one": one_k9,
                "rounding_floor": floor, "logit_bound": bound,
                "k9_routes": dict(ROUTES.get("flash_attention", {})),
                "one_ms_per_token": one_tok_ms,
                "logit_gap": gap, "logit_max": top,
                "tokens_equal": bool(torch.equal(seqs, one_seqs)),
                "one_peak_gb": _peak_gb(dev), "one_routing": one_route,
                "rerouted": _flips(one_routes, routes)})
    # an MoE token whose top-k (or its order) flips at a router near tie
    # changes its layer's output, and attention carries it on: then the
    # first flip must be a near tie, and the logits' gap is reported
    flipped = out["rerouted"]["tokens"] > 0
    out["ok"] = out["tokens_equal"] and (
        gap <= bound if not flipped
        else out["rerouted"]["first_margin"] <= NEAR_TIE)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--data", type=int, default=None,
                    help="the data extent (default: ranks / model)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--lr", type=float, default=ARGS["lr"])
    ap.add_argument("--against", default=None,
                    help="JSON of another run of the arch, whose losses "
                         "this run's must follow")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--prompt", type=int, default=4096,
                    help="the prefill's tokens (--serve; a VLM's patches "
                         "come before them)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="the weights' type (default: the config's in "
                         "training, float32 with --serve)")
    ap.add_argument("--spread", action="store_true",
                    help="a third run on rank 0 from the weights changed by "
                         "one rounding: the one card's own spread of the "
                         "losses and grad norms (training)")
    ap.add_argument("--hvp", action="store_true",
                    help="Hutchinson curvature (z * Hz) in the fednl steps "
                         "(training)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="a directory for the JSON line (default: print only)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        build_all()
    out = serve_check(args, dev) if args.serve else train_check(args, dev)
    if not out:
        return 0
    out["cards"] = _card(dev)
    line = json.dumps({"mesh_train_check": out})
    print(line, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        mesh = out["mesh"]
        name = (f"{args.arch}{f'_L{args.layers}' if args.layers else ''}"
                f"{f'_lr{args.lr:g}' if args.lr != ARGS['lr'] else ''}"
                f"{f'_{args.dtype}' if args.dtype else ''}"
                f"{'_hvp' if args.hvp else ''}"
                f"_{mesh['data']}x{mesh['model']}"
                f"{'_serve' if args.serve else ''}.json")
        with open(os.path.join(args.out, name), "w") as f:
            f.write(line + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
