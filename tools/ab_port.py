#!/usr/bin/env python3
"""Time checkouts of the port against each other on one card, in turns
(A, B, ..., B, A), so that the comparison shares a card and its power
limit.

    python3 tools/ab_port.py DIR_A DIR_B [DIR_C ...]

Each DIR is the root of a checkout (it holds ``src/repro_torch``). Per
turn a fresh process imports that checkout's package, builds its kernels
into its own ``build/kernels``, and measures, with the timers of
``chip_smoke.py`` (this tool's own checkout):
  * on the w8a stand-in (n=142, d=300, f64): the fused Block-Top-K
    uplink ``diff_topk_payload`` (k=8, CUDA events over 50 calls, and its
    device time from the profiler) and the median of 20 FedNL rounds,
    Block-Top-K 8, Options 1 and 2;
  * on the curvature refresh's largest tensor, qwen2-0.5B's embedding
    (4 silo observations of 151,936 x 896 f32 against one shared H, k =
    2048 of 128^2, random from a fixed seed): K1 ``diff_topk_payload``
    and K4 ``block_scatter_accumulate`` on K1's payloads, each by CUDA
    events (10 calls) and its device time from the profiler.
Prints one JSON line per turn (a turn that fails prints its error and
the rest go on), then the card; exits 1 if any turn failed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import torch
    from chip_smoke import device_ms, host_ms, time_cuda
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.data import make_problem
    from repro_torch.kernels import build_all
    from repro_torch.kernels.block_topk import diff_topk_payload
    from repro_torch.kernels.scatter_accum import block_scatter_accumulate

    build_all()
    prob = make_problem("w8a", seed=0)
    x0 = torch.zeros(prob["d"], dtype=torch.float64, device="cuda")
    h_new, h_old = prob["hess"](x0), prob["hess"](prob["xstar"])

    def k1():
        return diff_topk_payload(h_new, h_old, k=8)

    out = {"k1_ms": time_cuda(k1),
           "k1_device_ms": device_ms(k1, "diff_topk_payload_kernel")}
    for option in (1, 2):
        alg = FedNL(prob["grad"], prob["hess"], make_compressor("blocktopk", 8),
                    option=option, mu=1e-3)
        state = alg.init(x0, prob["n"])
        times = []
        for _ in range(22):
            ms, state = host_ms(lambda: alg.step(state))
            times.append(ms)
        out[f"round_ms_option{option}"] = statistics.median(times[2:])
    del prob, h_new, h_old

    # the refresh's embed tensor: 4 x (151936, 896) f32 against one H
    gen = torch.Generator(device="cuda").manual_seed(0)
    obs = torch.randn((4, 151936, 896), generator=gen, device="cuda") * 1e-2
    h = torch.randn((151936, 896), generator=gen, device="cuda") * 1e-2
    grid = (151936 // 128, 896 // 128)
    vals, idx, _ = diff_topk_payload(obs, h, 2048, 128)
    src = (Path(root) / "src/repro_torch/csrc/scatter_accum.cu").read_text()
    k4_kernel = ("block_scatter_kernel" if "block_scatter_kernel" in src
                 else "accumulate_kernel<float, true>")

    def k1_embed():
        return diff_topk_payload(obs, h, 2048, 128)

    def k4_embed():
        return block_scatter_accumulate(vals, idx, grid, 128)

    out.update({
        "embed_k1_ms": time_cuda(k1_embed, reps=10),
        "embed_k1_device_ms": device_ms(k1_embed, "diff_topk_payload_kernel",
                                        reps=5),
        "embed_k4_ms": time_cuda(k4_embed, reps=10),
        "embed_k4_device_ms": device_ms(k4_embed, k4_kernel, reps=5)})
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])))
        return 0
    roots = sys.argv[1:]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    failed = False
    for root in roots + roots[::-1]:
        run = subprocess.run([sys.executable, __file__, "--measure", root],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            failed = True
            print(json.dumps({"tree": root, "error": run.stderr[-2000:]}),
                  flush=True)
            continue
        row = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": root, **row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
