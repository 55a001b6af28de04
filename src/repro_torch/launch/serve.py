"""Serving driver: batched prompt and decode loop against a KV cache,
the counterpart of ``src/repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --batch 4 --prompt-len 64 --gen 32 --greedy

runs the full model on the card (``--smoke`` for the reduced one,
``--device cpu`` for the CPU). Weights, prompt, an encoder-decoder's
memory and sampling all come from one ``torch.Generator`` seeded by
``--seed``. A VLM serves text alone, as in the reference. Over the ranks
of a mesh (``torchrun``; one rank when started alone) the batch is
spread over the data axis, and the weights are held whole over it; a
"model" axis (``generate(mesh=make_host_mesh(data, model))``) splits
them by the rules, each rank computing its heads, d_ff columns and
vocab rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..models import build_model
from ..models.common import installed_hooks, set_activation_sharder
from ..tree import tree_map
from .mesh import extents, make_host_mesh, scoped_group
from .sharding import (DataAxis, cache_specs, check_model_axis, local_keep,
                       model_parts, tree_param_specs)
from .steps import make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def argmax_over(logits: torch.Tensor, tp=None) -> torch.Tensor:
    """``torch.argmax(logits, dim=-1)``; over a "model" axis ``tp``,
    ``logits`` is this rank's block of the vocab (rows rank * V / M
    onward): each rank's max and its first index, gathered, and the first
    rank holding the largest, so ties go to the lower index, as
    ``jnp.argmax``."""
    if tp is None:
        return torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    val, idx = torch.max(logits, dim=-1)
    vals, idxs = tp.gather(val[None], (idx + tp.rank * v)[None])
    best = torch.argmax(vals, dim=0)
    return torch.gather(idxs, 0, best[None])[0]


def generate(arch: str, smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, seed: int = 0,
             temperature: float = 1.0, greedy: bool = False, device=None,
             params=None, memory=None, mesh=None) -> torch.Tensor:
    """(batch, prompt_len + gen) token ids: a random prompt, then ``gen``
    greedy or temperature-sampled tokens (Gumbel-max over the logits /
    ``temperature``, the reference's ``jax.random.categorical`` rule).
    ``params`` replaces the drawn weights (a test hands in the
    reference's; the KV cache takes the type of their embeddings, not of
    an MoE's f32 router). For an encoder-decoder, the cache's encoder
    memory (batch, enc_seq, d) is ``memory``, or else N(0, 1) * 0.02 drawn
    after the prompt, as in the reference. Prints the host time of the
    prompt and of the decode loop.

    ``mesh``: each rank of its data axis decodes its own rows of the
    batch with the weights whole over "data"; the prompt, the memory and
    every sampling draw are made for the whole batch on every rank, each
    rank keeping its rows, and the tokens are gathered at the end, so
    every rank returns what one process would (an MoE routes each rank's
    rows as its decode group). Over a "model" axis (every family; widths
    the axis does not divide, and Hutchinson curvature in training, raise
    ``NotImplementedError`` first) each rank draws the weights layer by
    layer and keeps its shards (or takes them of the handed ``params``),
    lays its cache out by ``cache_specs`` (its KV heads, else its slice
    of the sequence, else whole; MLA's latent cache its slice of the
    sequence, else whole; a Mamba layer's conv window and state its
    channels; an mLSTM's C its heads where H divides, with n and m whole
    on every rank; an sLSTM's state and the encoder's memory whole),
    decodes through the tensor-parallel layers (an MoE's experts, or
    each expert's d_ff), and picks tokens over the vocab's shards
    (``argmax_over``; the Gumbel draws are the whole vocab's), or over
    the whole vocab where the axis does not divide it."""
    cfg = get_config(arch, smoke=smoke)
    if params is not None:
        dtype = str(params["embed"].dtype).removeprefix("torch.")
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = resolve_device(device)
    if mesh is not None:
        check_model_axis(cfg, extents(mesh))
    axis = None if mesh is None else DataAxis(mesh)
    tp = None if axis is None or axis.model.world == 1 else axis.model
    world, rank = (1, 0) if axis is None else (axis.world, axis.rank)
    if batch % world:
        raise ValueError(f"batch {batch} must divide into {world} ranks")
    rows = batch // world
    mine = slice(rank * rows, (rank + 1) * rows)
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = model.init_params(g, keep=None if tp is None else local_keep(
            mesh, extents(mesh), axes=("model",)))
    elif tp is not None:
        params = model_parts(params, tree_param_specs(params, extents(mesh)),
                             tp)
    serve = make_serve_step(model)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=dev)[mine]
    cache = model.init_cache(rows, prompt_len + gen, dev)
    if tp is not None:
        specs = cache_specs(cache, extents(mesh))
        cache = tree_map(torch.clone, model_parts(cache, specs, tp))
        # the sequence splits where cache_specs splits it: the KV caches
        # where their heads do not split, the latent caches always
        split_seq = (prompt_len + gen) % tp.world == 0
        cache["kv_seq"] = bool(cfg.kv_heads % tp.world and split_seq)
        cache["latent_seq"] = cfg.attn_type == "mla" and split_seq
    # the vocab's shards: whole on every rank where the axis does not
    # divide it (the rules replicate the table)
    vtp = None if tp is None or cfg.vocab % tp.world else tp
    vocab = slice(None) if vtp is None else slice(
        vtp.rank * (cfg.vocab // vtp.world),
        (vtp.rank + 1) * (cfg.vocab // vtp.world))
    if cfg.family == "encdec":
        enc = (torch.randn((batch,) + tuple(cache["enc"].shape[1:]),
                           generator=g, device=dev).to(cfg.tdtype) * 0.02
               if memory is None else memory.to(dev, cfg.tdtype))
        cache["enc"] = enc[mine]

    hooks = installed_hooks()
    if tp is not None:
        set_activation_sharder(None, None, tp)
    try:
        # the prompt goes in token by token through the serve path, as in
        # the reference (a fused prefill is the fast path)
        _sync(dev)
        t0 = time.perf_counter()
        logits = None
        for pos in range(prompt_len):
            logits, cache = serve(params, cache, prompt[:, pos:pos + 1], pos)
        _sync(dev)
        t1 = time.perf_counter()
        out = [prompt]
        for i in range(gen):
            if greedy:
                nxt = argmax_over(logits[:, -1], vtp)[:, None]
            else:
                u = torch.rand((batch, cfg.vocab), generator=g,
                               device=dev)[mine, vocab]
                gumbel = -torch.log(-torch.log(
                    u.clamp_min(torch.finfo(torch.float32).tiny)))
                nxt = argmax_over(logits[:, -1].float() / temperature
                                  + gumbel, vtp)[:, None]
            out.append(nxt)
            logits, cache = serve(params, cache, nxt, prompt_len + i)
        _sync(dev)
    finally:
        if tp is not None:
            set_activation_sharder(*hooks)
    dt = time.perf_counter() - t1
    if rank == 0 and (tp is None or tp.rank == 0):
        print(f"prompt of {prompt_len} tokens x {batch} seqs in "
              f"{t1 - t0:.4f}s; generated {gen} tokens x {batch} seqs in "
              f"{dt:.4f}s ({batch * gen / dt:.1f} tok/s)")
    seqs = torch.cat(out, dim=1)
    if axis is not None:
        seqs, = axis.gather(seqs)
    return seqs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (default: the published one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    with scoped_group():
        mesh = make_host_mesh(device=args.device)
        seqs = generate(args.arch, smoke=args.smoke, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        seed=args.seed, temperature=args.temperature,
                        greedy=args.greedy, device=args.device, mesh=mesh)
        if DataAxis(mesh).rank == 0:
            print("sample token ids:", seqs[0, : args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
