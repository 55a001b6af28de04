"""Serving driver: batched prompt and decode loop against a KV cache,
the counterpart of ``src/repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --batch 4 --prompt-len 64 --gen 32 --greedy

runs the full model on the card (``--smoke`` for the reduced one,
``--device cpu`` for the CPU). Weights, prompt, an encoder-decoder's
memory and sampling all come from one ``torch.Generator`` seeded by
``--seed``. A VLM serves text alone, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..models import build_model
from .steps import make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(arch: str, smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, seed: int = 0,
             temperature: float = 1.0, greedy: bool = False, device=None,
             params=None, memory=None) -> torch.Tensor:
    """(batch, prompt_len + gen) token ids: a random prompt, then ``gen``
    greedy or temperature-sampled tokens. ``params`` replaces the drawn
    weights (a test hands in the reference's; the KV cache takes the
    type of their embeddings, not of an MoE's f32 router). For an
    encoder-decoder, the cache's encoder memory (batch, enc_seq, d) is
    ``memory``, or else N(0, 1) * 0.02 drawn after the prompt, as in the
    reference. Prints the host time of the prompt and of the decode
    loop."""
    cfg = get_config(arch, smoke=smoke)
    if params is not None:
        dtype = str(params["embed"].dtype).removeprefix("torch.")
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = resolve_device(device)
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = model.init_params(g)
    serve = make_serve_step(model)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=dev)
    cache = model.init_cache(batch, prompt_len + gen, dev)
    if cfg.family == "encdec":
        cache["enc"] = (torch.randn(cache["enc"].shape, generator=g,
                                    device=dev).to(cfg.tdtype) * 0.02
                        if memory is None else memory.to(dev, cfg.tdtype))

    # the prompt goes in token by token through the serve path, as in the
    # reference (a fused prefill is the fast path)
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
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        else:
            probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=g)
        out.append(nxt)
        logits, cache = serve(params, cache, nxt, prompt_len + i)
    _sync(dev)
    dt = time.perf_counter() - t1
    print(f"prompt of {prompt_len} tokens x {batch} seqs in {t1 - t0:.4f}s; "
          f"generated {gen} tokens x {batch} seqs in {dt:.4f}s "
          f"({batch * gen / dt:.1f} tok/s)")
    return torch.cat(out, dim=1)


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
    seqs = generate(args.arch, smoke=args.smoke, batch=args.batch,
                    prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                    temperature=args.temperature, greedy=args.greedy,
                    device=args.device)
    print("sample token ids:", seqs[0, : args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
