"""Where xLSTM's f32 gap over a played "model" axis comes from, layer by
layer.

    python3 tools/xlstm_axis_gap.py [--t 512] [--layers 24] [--draws 8] \\
        [--device cuda] [--out FILE]

builds xlstm-350m at its published width (d 1,024, 4 heads of 256, an
sLSTM every 8th layer), ``--layers`` deep, in f32 from ``--seed``, records
each layer's input in the unsplit model's prefill of one (1, ``--t``)
prompt and runs every layer alone on that input (teacher-forced, as
``chip_smoke.py`` phase 16e does):

- unsplit from its weights ``tree.nudged``, ``--draws`` draws: the
  layer's own spread under rounding, the largest gap over the draws;
- on 4 ranks played by threads (``chip_smoke.played_model_axis``: an
  mLSTM head a rank, from its column shards of ``wq``/``wk``/``wv``/
  ``wo_gate``/``wif``) and on 16 (the 4 heads do not split: every head
  from those weights gathered whole), against the unsplit layer;
- both again with every ``wout`` the identity, so that a layer's output
  is its input plus the heads' y * o (the sLSTM's y): the gap the heads'
  route makes, without the row-parallel sum over the ranks.

Every gap is the largest |difference| over the largest |output| of the
unsplit layer. Beside them: whether a product with a column shard of a
weight (x @ w[:, cols]) equals those columns of the whole product bit for
bit on this device, and one sLSTM layer's played prefill over 16 ranks
timed with the ranks in turns and free (host clock). One JSON line;
``--out FILE`` writes it there too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.sharding import tree_param_specs  # noqa: E402
from repro_torch.launch.steps import make_prefill  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import nudged, tree_map  # noqa: E402

ARCH = "xlstm-350m"


class _Free:
    """A turn that every rank holds at once: the played ranks run free."""

    def acquire(self):
        return True

    def release(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _identity_wout(params):
    """``params`` with every layer's ``wout`` the identity (stacked)."""
    out = tree_map(lambda x: x, params)
    for layer in out["layers"]:
        w = layer["mixer"]["wout"]
        layer["mixer"]["wout"] = torch.eye(
            w.shape[-1], dtype=w.dtype, device=w.device).expand_as(w).clone()
    return out


def _layer_out(model, params, i, x):
    seg, pos = divmod(i, model.period)
    return tf._layer_forward(tf._layer(params["layers"][pos], seg), x,
                             model.cfg, *model.kinds[pos])[0]


def _played(model, params, world, i, x):
    """Layer ``i`` on ``world`` played ranks from ``x``: rank 0's output,
    which every rank's must equal."""
    ext = {"data": 1, "model": world}
    shards = smoke.rank_shards(tree_map(lambda t: t, params),
                               tree_param_specs(params, ext), world)
    axis = smoke.played_model_axis(world)
    outs = smoke.play_ranks(axis, lambda r: _layer_out(model, shards[r], i, x))
    assert all(torch.equal(outs[0], o) for o in outs[1:]), "ranks differ"
    return outs[0]


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / float(
        b.float().abs().max())


def _slice_bitwise(dev, seed: int, t: int, d: int, world: int) -> dict:
    """x @ w[:, cols] against (x @ w)[:, cols], (T, d) @ (d, d), f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, t, d), generator=g, device=dev)
    w = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    whole = x @ w
    size = d // world
    gaps = [float((x @ w[:, r * size:(r + 1) * size].contiguous()
                   - whole[..., r * size:(r + 1) * size]).abs().max())
            for r in range(world)]
    return {"shape": f"(1, {t}, {d}) @ ({d}, {size})",
            "bitwise": max(gaps) == 0.0, "max_abs_gap": max(gaps),
            "largest": float(whole.abs().max())}


def _slstm_turns(model, params, i, x, world: int, dev) -> dict:
    """Layer ``i`` (an sLSTM) on ``world`` played ranks, host ms in turns
    and free, each after a warm-up."""
    ext = {"data": 1, "model": world}
    shards = smoke.rank_shards(tree_map(lambda t: t, params),
                               tree_param_specs(params, ext), world)
    out = {}
    for name in ("turns", "free"):
        axis = smoke.played_model_axis(world)
        if name == "free":
            axis.turn = _Free()
        smoke.play_ranks(axis, lambda r: _layer_out(model, shards[r], i,
                                                     x[:, :64]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        smoke.play_ranks(axis, lambda r: _layer_out(model, shards[r], i, x))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=None,
                    help="d_model (default: the published 1,024)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=args.layers, dtype="float32",
                              d_model=args.width or cfg.d_model)
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init_params(g)
    tokens = torch.randint(0, cfg.vocab, (1, args.t), generator=g, device=dev)
    with smoke.layers_recorded() as rec:
        make_prefill(model)(params, {"tokens": tokens})
    eye = _identity_wout(params)
    layers = []
    for i, (x, want) in enumerate(rec):
        kind = model.kinds[i % model.period][0]
        entry = {"layer": i, "kind": kind}
        want_eye = _layer_out(model, eye, i, x)
        spread = spread_eye = 0.0
        for _ in range(args.draws):
            moved = nudged(params, g)
            spread = max(spread, _gap(_layer_out(model, moved, i, x), want))
            moved = _identity_wout(moved)
            spread_eye = max(spread_eye,
                             _gap(_layer_out(model, moved, i, x), want_eye))
            del moved
        entry.update(spread=spread, spread_heads=spread_eye)
        for world in (4, 16):
            entry[f"gap_{world}"] = _gap(_played(model, params, world, i, x),
                                         want)
            entry[f"gap_heads_{world}"] = _gap(
                _played(model, eye, world, i, x), want_eye)
        layers.append(entry)
        print(json.dumps(entry), flush=True)
    worst = {}
    for kind in ("mlstm", "slstm"):
        rows = [e for e in layers if e["kind"] == kind]
        worst[kind] = {key: max(e[key] for e in rows) for key in rows[0]
                       if key not in ("layer", "kind")}
    slstm = next(i for i, e in enumerate(layers) if e["kind"] == "slstm")
    card = None
    if dev.type == "cuda":
        card = smoke.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    rep = {"arch": ARCH, "d_model": cfg.d_model, "layers": cfg.n_layers,
           "t": args.t, "draws": args.draws, "card": card,
           "worst_by_kind": worst, "layers_detail": layers,
           "column_shard_product": _slice_bitwise(dev, args.seed, args.t,
                                                  cfg.d_model, 4),
           "slstm_played_16": _slstm_turns(model, params, slstm,
                                           rec[slstm][0], 16, dev),
           "s": time.perf_counter() - t0}
    line = json.dumps({"xlstm_axis_gap": rep})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
