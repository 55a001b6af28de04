#!/usr/bin/env python3
"""Where a qwen2-0.5B decode step's time goes on one card, and what a
profiler session does to the launches after it in the same process.

    python3 tools/decode_profile.py [--seed N]

Full model, bf16, random weights from --seed; batch 4, a 200-token
cache. In one fresh process, in this order:
  1. host ms per decode step over 150 steps (twice), no profiler yet;
  2. 5 steps under ``torch.profiler``: device busy ms per step, idle
     share, and the ops PyTorch dispatched per step;
  3. host ms per step again (twice), after that one session;
  4. 640 more steps, then six profiler sessions of 3 K9 launches
     (T = 4,096): how many launches each session recorded.
Prints one JSON line per step, then the card. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        print("decode_profile: CUDA is not available", file=sys.stderr)
        return 1
    build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(get_config("qwen2-0.5b"))
    params = model.init_params(gen)
    serve = make_serve_step(model)
    toks = torch.randint(0, model.cfg.vocab, (4, 200), generator=gen, device=dev)

    def steps(n: int) -> float:
        """Host ms per decode step over n steps from an empty cache."""
        cache = model.init_cache(4, 200, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for p in range(n):
            _, cache = serve(params, cache, toks[:, p:p + 1], p)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n

    steps(20)                                        # warm-up
    print(json.dumps({"step_ms_before_profiler": [steps(150), steps(150)]}))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        steps(5)
        wall = (time.perf_counter() - t) * 1e3
    rows = prof.key_averages()
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    kernels = sum(e.count for e in rows
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({"profiled_5_steps": {
        "wall_ms_per_step": wall / 5, "device_busy_ms_per_step": busy / 5,
        "idle_share": 1.0 - busy / wall, "kernels_per_step": kernels / 5}}))
    print(json.dumps({"step_ms_after_profiler": [steps(150), steps(150)]}))

    for _ in range(4):
        steps(160)                                   # 640 more steps
    q = torch.randn((1, 4096, 14, 64), generator=gen, device=dev).bfloat16()
    kv = torch.randn((1, 4096, 2, 64), generator=gen, device=dev).bfloat16()
    recorded = []
    for _ in range(6):
        with profile(activities=acts) as prof:
            for _ in range(3):
                flash_attention(q, kv, kv)
            torch.cuda.synchronize()
        recorded.append(sum(e.count for e in prof.key_averages()
                            if "flash_attention_kernel" in e.key))
    print(json.dumps({"k9_launches_recorded_of_3": recorded}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
