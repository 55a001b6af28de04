"""Dry run of every (arch x input-shape) pair on the meta device, the
counterpart of ``src/repro/launch/dryrun.py``: no card, no process
group, no weights.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out rows.jsonl]

The reference lowers and compiles each pair for 256 (or 512) fake XLA
devices and reads XLA's cost and memory analyses. Eager PyTorch has no
compiled program, so here the model and its step run on ``meta``
tensors (shapes and dtypes, no storage) under ``CostMode``, a
``TorchDispatchMode`` that sees every aten op:

* FLOPs are the matrix products, as ``torch.utils.flop_counter`` counts
  them (mm, addmm, bmm, baddbmm, convolutions, SDPA: 2 per
  multiply-add), plus the hand-written kernels' own products (K9: 4 hd a
  (query, key) pair it visits, the causal half of the square, or the
  window's band). Elementwise ops and reductions add bytes, not FLOPs.
* Bytes are the sum over ops of the bytes each reads and writes (every
  tensor argument and result, views and allocations excepted), with no
  fusion and no cache: an upper bound of what an eager step moves
  through HBM. The kernels (K1, K4, K9) add their inputs and outputs
  once.
* The counts are global; a row gives them per card, divided by the
  mesh's extent. The mesh is a plain ``{axis: extent}`` dict (16 x 16,
  or 2 x 16 x 16 with ``--multi-pod``), which the sharding rules read.
* Collective bytes are ``roofline.collective_bytes`` of the rules.
* Per-card memory is reckoned from trees under the rules' specs:
  arguments are the parameters, the optimizer state and the batch (the
  cache for decode); outputs the parameters and optimizer state
  (train), the logits (prefill) or the logits and cache (decode);
  temporaries the gradients (and their f32 accumulators when the batch
  is split), one saved (B, T, d) input a layer (remat) and a
  microbatch's f32 logits and their gradient (train), or two (B, T, d)
  residual streams (prefill). Intermediates inside a layer are not in
  it: a lower bound of the peak.

The train step counts one pass of the whole batch (``microbatches=1``:
the same arithmetic as k accumulated passes), as the reference's
probes do. Where the reference extrapolates a deep stack linearly from
one- and two-period probes, here the quadratic through two-, three- and
four-period probes is taken (``_probe_costs``), and the sLSTM's step
loop likewise over lengths (``length_probe``): both give the full count
exactly, as the tests check, where a line would not (autograd makes
each layer's gradient a stack-sized tensor, and each token's in the
sLSTM a sequence-sized one).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, get_config, model_param_shapes
from ..kernels.call_sites import swapped
from ..models import build_model
from ..models.transformer import layer_kinds
from ..tree import tree_leaves, tree_map
from .roofline import Roofline, collective_bytes, model_flops
from .shapes import SHAPES, decode_input_specs, skip_reason, token_batch_specs
from .sharding import (
    batch_specs,
    cache_specs,
    opt_state_shardings,
    tree_param_specs,
)
from .steps import make_optimizer, make_prefill, make_serve_step, make_train_step

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

_aten = torch.ops.aten
# ops that move no data: allocations without a fill, and metadata
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.detach,
         _aten.lift_fresh, _aten.alias}


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


class CostMode(TorchDispatchMode):
    """FLOPs and bytes of every aten op run under it (module docstring),
    and the number of ops."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def add(self, flops: int = 0, nbytes: int = 0) -> None:
        """Work done outside aten (a hand-written kernel's)."""
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not (func.is_view or packet in _FREE):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def attention_pairs(t: int, window: int | None = None) -> int:
    """(query, key) pairs causal attention over t tokens visits: i + 1
    keys for query i, or at most ``window``."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


@contextlib.contextmanager
def kernels_counted(mode: CostMode):
    """The hand-written kernels of the port's paths, which raise on a meta
    tensor, replaced at their call sites (``kernels/call_sites.py``) by
    stand-ins that give outputs of their shapes and add their work to
    ``mode``: K9 (``flash_attention``), K1 (``diff_topk_payload``) and K4
    (``block_scatter_accumulate``). Restored on exit."""

    def flash_attention(_wrapper, q, k, v, bq=None, bk=None, window=None):
        b, t, h, hd = q.shape
        out = torch.empty_like(q)
        mode.add(4 * b * h * hd * attention_pairs(t, window),
                 _nbytes((q, k, v, out)))
        return out

    def diff_topk_payload(_wrapper, a, b, k, block=128):
        dt = torch.promote_types(a.dtype, b.dtype)
        n, m, nc = a.shape
        k = min(int(k), block * block)
        tiles = -(-m // block) * -(-nc // block)
        vals = torch.empty((n, tiles, k), dtype=dt, device=a.device)
        idx = torch.empty((n, tiles, k), dtype=torch.int32, device=a.device)
        sq = torch.empty((n,), dtype=dt, device=a.device)
        reads_b = n if b.dim() == 2 else 1
        mode.add(0, _nbytes((a, vals, idx, sq)) + reads_b * _nbytes(b))
        return vals, idx, sq

    def block_scatter_accumulate(_wrapper, values, indices, grid, block):
        gm, gn = (int(g) for g in grid)
        out = torch.empty((gm * block, gn * block), dtype=values.dtype,
                          device=values.device)
        mode.add(values.numel(), _nbytes((values, indices, out)))
        return out

    with swapped({"flash_attention": flash_attention,
                  "diff_topk_payload": diff_topk_payload,
                  "block_scatter_accumulate": block_scatter_accumulate}):
        yield mode


def meta_params(cfg) -> dict:
    """The model's parameter tree as meta tensors (``model_param_shapes``)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    model_param_shapes(cfg))


def _run_step(cfg, shape, optimizer: str, model, refresh: bool = True,
              opt_kw: dict | None = None):
    """Build ``shape.kind``'s step for ``cfg`` on meta stand-ins and run
    it once. A train step takes ``make_optimizer(optimizer, **opt_kw)``
    and ``make_train_step``'s defaults (one microbatch, one silo); a
    second-order optimizer refreshes its curvature unless ``refresh`` is
    False (the state's step is then 1 of a refresh every 2)."""
    params = meta_params(cfg)
    if shape.kind == "train":
        opt = make_optimizer(optimizer, 1e-4, moment_dtype=torch.bfloat16,
                             **(opt_kw or {}))
        state = opt.init(params)
        if not refresh:
            state = state._replace(step=1)
        batch = token_batch_specs(cfg, shape)
        make_train_step(model, opt, refresh_every=1 if refresh else 2)(
            params, state, batch)
    elif shape.kind == "prefill":
        make_prefill(model)(params, token_batch_specs(cfg, shape))
    else:
        specs = decode_input_specs(cfg, shape, model)
        make_serve_step(model)(params, specs["cache"], specs["token"],
                               shape.seq_len - 1)


def count_step(cfg, shape, optimizer: str = "adamw", **train) -> dict:
    """Global FLOPs, bytes and aten ops of one step of ``shape.kind`` for
    ``cfg`` at ``shape``, every layer and every token run; ``train``
    goes to ``_run_step`` (``refresh``, ``opt_kw``)."""
    model = build_model(cfg, use_remat=True)
    mode = CostMode()
    with kernels_counted(mode), mode:
        _run_step(cfg, shape, optimizer, model, **train)
    return {"flops": mode.flops, "bytes": mode.bytes, "ops": mode.ops}


def _quadratic(c2: dict, c3: dict, c4: dict, units: int) -> dict:
    """Key by key, the quadratic through the counts of 2, 3 and 4 units
    at ``units`` (Lagrange's form; each product of two consecutive
    integers is even, so the sums stay exact integers). One unit is left
    out: a stack of one segment, or one chunk, skips some copies."""
    m = units - 1                      # 2, 3, 4 units at m = 1, 2, 3
    return {key: (c2[key] * (m - 2) * (m - 3) // 2
                  - c3[key] * (m - 1) * (m - 3)
                  + c4[key] * (m - 1) * (m - 2) // 2) for key in c2}


def length_probe(cfg, shape) -> int | None:
    """The probe length of a stack with a step loop over T (the sLSTM:
    about 22 aten ops a token, each a Python dispatch here): its mLSTM
    chunk, when T is a multiple of it above four of them; else None.
    Such a stack's FLOPs are affine in T at multiples of the chunk (fixed
    chunks, fixed work a token), and its bytes quadratic: in training the
    gradient of each token's slice of the (B, T, 4d) pre-activations is a
    (B, T, 4d) tensor that autograd adds whole. Three lengths from two
    chunks up give every count exactly (the tests hold it)."""
    if (shape.kind == "decode" or cfg.xlstm is None
            or not any(m == "slstm" for m, _ in layer_kinds(cfg))):
        return None
    t1 = cfg.xlstm.chunk
    if shape.seq_len <= 4 * t1 or shape.seq_len % t1:
        return None
    return t1


def count_step_probed(cfg, shape, optimizer: str = "adamw", **train) -> dict:
    """``count_step``, or where ``length_probe`` gives t1, the counts at
    2 t1, 3 t1 and 4 t1 carried to T / t1 by ``_quadratic``."""
    t1 = length_probe(cfg, shape)
    if t1 is None:
        return count_step(cfg, shape, optimizer, **train)
    return _quadratic(*(count_step(cfg, dataclasses.replace(
        shape, seq_len=j * t1), optimizer, **train) for j in (2, 3, 4)),
        shape.seq_len // t1)


def _probe_costs(cfg, shape, optimizer: str, model,
                 **train) -> tuple[dict, str]:
    """Every layer counted up to 8 layers (or 4 periods); above, two-,
    three- and four-period probes carried to ``model.n_segments`` periods
    by ``_quadratic``: each layer's gradient is taken through a view of
    its stacked leaves, which autograd turns into a stack-sized tensor,
    so a training step's bytes grow with the square of the depth."""
    tag = "+length-probes" if length_probe(cfg, shape) else ""
    segs = model.n_segments
    if cfg.n_layers <= 8 or segs <= 4:
        return (count_step_probed(cfg, shape, optimizer, **train),
                "every-layer" + tag)
    enc_per = (cfg.enc_layers // segs) if cfg.enc_layers else 0
    return _quadratic(*(count_step_probed(dataclasses.replace(
        cfg, n_layers=n * model.period, enc_layers=n * enc_per), shape,
        optimizer, **train) for n in (2, 3, 4)), segs), (
        "probe-extrapolated" + tag)


def train_step_roofline(cfg, batch: int, seq: int, optimizer: str = "fednl",
                        refresh: bool = True, **opt_kw) -> tuple[Roofline,
                                                                 dict]:
    """The roofline on one card of a train step of ``cfg`` at ``batch`` x
    ``seq`` tokens, as a measured step ran it: ``optimizer`` made with
    ``opt_kw``, a curvature refresh or not. Counted as one pass of the
    whole batch with one silo: the same products as a step split into
    microbatches and silo shards, and fewer bytes (no f32 accumulators;
    H read once, not once a silo), so its terms bound that step from
    below. Returns (the roofline, the counts)."""
    from .shapes import InputShape

    shape = InputShape("measured", seq, batch, "train")
    counts, _ = _probe_costs(cfg, shape, optimizer,
                             build_model(cfg, use_remat=True),
                             refresh=refresh, opt_kw=opt_kw)
    rl = Roofline(flops=counts["flops"], bytes_hbm=counts["bytes"],
                  coll={}, chips=1,
                  model_flops=model_flops(cfg, shape, "train"))
    return rl, counts


def _spec_extent(ext: dict, spec) -> int:
    out = 1
    for entry in spec or ():
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out *= int(ext.get(axis, 1))
    return out


def _per_device(tree, specs, ext: dict, itemsize: int | None = None) -> int:
    """Bytes per card of ``tree``'s leaves under ``specs`` (a tree like
    it of specs), at their own item size or ``itemsize``."""
    return sum(x.numel() * (itemsize or x.element_size())
               // _spec_extent(ext, s)
               for x, s in zip(tree_leaves(tree), tree_leaves(specs)))


def memory_per_device(cfg, shape, ext: dict, optimizer: str,
                      microbatches: int) -> dict:
    """argument, output and temp bytes per card from the trees under the
    rules' specs (module docstring), on meta stand-ins."""
    model = build_model(cfg, use_remat=True)
    params = meta_params(cfg)
    p_specs = tree_param_specs(params, ext)
    p_bytes = _per_device(params, p_specs, ext)
    n_b = _spec_extent(ext, [("pod", "data")])
    b_dev = max(shape.global_batch // n_b, 1)
    item = cfg.tdtype.itemsize
    v_dev = cfg.vocab // (ext.get("model", 1)
                          if cfg.vocab % ext.get("model", 1) == 0 else 1)
    if shape.kind == "train":
        opt = make_optimizer(optimizer, 1e-4, moment_dtype=torch.bfloat16)
        state = opt.init(params)
        o_specs = opt_state_shardings(state, params, ext)
        o_bytes = sum(_per_device(f, s, ext) for f, s in zip(state, o_specs)
                      if isinstance(f, (dict, list)))
        batch = token_batch_specs(cfg, shape)
        args = p_bytes + o_bytes + _per_device(batch, batch_specs(batch, ext),
                                               ext)
        mb = max(min(microbatches, b_dev), 1)
        layers = cfg.n_layers + cfg.enc_layers
        acc = _per_device(params, p_specs, ext, 4) if microbatches > 1 else 0
        temp = (p_bytes + acc
                + layers * (b_dev // mb) * shape.seq_len * cfg.d_model * item
                + 2 * (b_dev // mb) * shape.seq_len * v_dev * 4)
        return {"argument": args, "output": p_bytes + o_bytes, "temp": temp}
    if shape.kind == "prefill":
        batch = token_batch_specs(cfg, shape)
        args = p_bytes + _per_device(batch, batch_specs(batch, ext), ext)
        return {"argument": args,
                "output": b_dev * shape.seq_len * v_dev * item,
                "temp": 2 * b_dev * shape.seq_len * cfg.d_model * item}
    specs = decode_input_specs(cfg, shape, model)
    c_bytes = _per_device(specs["cache"], cache_specs(specs["cache"], ext),
                          ext)
    return {"argument": p_bytes + c_bytes + b_dev * 4,
            "output": b_dev * v_dev * item + c_bytes, "temp": 0}


def dryrun_pair(arch: str, shape_name: str, multi_pod: bool = False,
                optimizer: str = "adamw", verbose: bool = True,
                with_probes: bool = True, smoke: bool = False,
                microbatches: int = 16) -> dict:
    """One pair's row, with the reference's keys (``skip`` rows with its
    reasons), on the 16 x 16 extents or, with ``multi_pod``, 2 x 16 x 16;
    ``smoke`` takes the reduced config.
    ``with_probes=False`` runs one period alone and reports its counts
    ("one-period"), as the reference's compile-only pass."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": reason}
    name = "2x16x16" if multi_pod else "16x16"
    ext = MESHES[name]
    chips = 1
    for v in ext.values():
        chips *= int(v)
    model = build_model(cfg, use_remat=True)

    t0 = time.time()
    mem = memory_per_device(cfg, shape, ext, optimizer, microbatches)
    params = meta_params(cfg)
    inputs = (token_batch_specs(cfg, shape) if shape.kind != "decode" else
              {"tokens": torch.empty((shape.global_batch, 1),
                                     dtype=torch.int32, device="meta")})
    coll = collective_bytes(params, inputs, ext, shape.kind,
                            act_itemsize=cfg.tdtype.itemsize)
    t_build = time.time() - t0
    t0 = time.time()
    if with_probes:
        costs, cost_mode = _probe_costs(cfg, shape, optimizer, model)
    else:
        enc_per = ((cfg.enc_layers // model.n_segments) if cfg.enc_layers
                   else 0)
        costs = count_step_probed(dataclasses.replace(
            cfg, n_layers=model.period, enc_layers=enc_per), shape, optimizer)
        cost_mode = "one-period"
    t_count = time.time() - t0
    rl = Roofline(flops=costs["flops"] / chips,
                  bytes_hbm=costs["bytes"] / chips, coll=coll, chips=chips,
                  model_flops=model_flops(cfg, shape, shape.kind))
    # lower_s: the stand-ins, memory and collectives; compile_s: the count
    row = {
        "arch": arch, "shape": shape_name, "mesh": name, "status": "ok",
        "kind": shape.kind,
        "optimizer": optimizer if shape.kind == "train" else None,
        "cost_mode": cost_mode, "lower_s": round(t_build, 1),
        "compile_s": round(t_count, 1), "aten_ops": costs["ops"],
        "argument_bytes": mem["argument"], "output_bytes": mem["output"],
        "temp_bytes": mem["temp"],
        "peak_bytes_per_device": mem["argument"] + mem["temp"],
        **rl.row(),
    }
    if verbose:
        print(f"== {arch} x {shape_name} on {name} ({shape.kind}) ==")
        print(f"  counted {costs['ops']} aten ops in {t_count:.1f}s "
              f"({cost_mode})")
        print(f"  memory per card: args={row['argument_bytes']} "
              f"temp={row['temp_bytes']} out={row['output_bytes']}")
        print(f"  per card: flops={rl.flops:.3e} bytes={rl.bytes_hbm:.3e}")
        print(f"  collectives: { {k: v for k, v in coll.items() if v} }")
        print(f"  roofline: compute={rl.t_compute:.4f}s "
              f"memory={rl.t_memory:.4f}s "
              f"collective={rl.t_collective:.4f}s -> {rl.bottleneck}-bound; "
              f"useful_ratio={rl.useful_ratio:.3f}")
        sys.stdout.flush()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "fednl"])
    ap.add_argument("--out", default=None, help="append JSONL rows here")
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs")
    ap.add_argument("--no-probes", action="store_true",
                    help="count one period alone (fast; the row's counts "
                         "are that period's, not the model's)")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    pairs = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    for arch, shape_name, mp in pairs:
        try:
            row = dryrun_pair(arch, shape_name, multi_pod=mp,
                              optimizer=args.optimizer,
                              with_probes=not args.no_probes,
                              smoke=args.smoke,
                              microbatches=args.microbatches)
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            row = {"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "fail", "error": repr(e)[:500]}
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
