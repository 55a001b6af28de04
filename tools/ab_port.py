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
    device time from the profiler), the server sums K2
    ``scatter_accumulate`` (Top-K k=300, plain and symmetric) and K4
    ``block_scatter_accumulate`` (Block-Top-K 8) on the round's payloads
    (wrapper ms by CUDA events, device ms per call from the profiler),
    and the median of 20 FedNL rounds, Top-K, symmetric Top-K and
    Block-Top-K 8, Options 1 and 2;
  * K2 at the K3 shape (142 Top-K payloads of k = 2,048 into 2,048 x
    2,048 f64, ``chip_smoke.k3_payloads``): wrapper ms (10 calls) and
    device ms per call; K2's device ms and launches per call are what
    the profiler records (``chip_smoke.device_per_call``);
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
    from chip_smoke import (
        K3_D,
        device_ms,
        device_per_call,
        host_ms,
        k3_payloads,
        time_cuda,
    )
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.data import make_problem
    from repro_torch.kernels import build_all
    from repro_torch.kernels.block_topk import diff_topk_payload
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        scatter_accumulate,
    )

    build_all()
    prob = make_problem("w8a", seed=0)
    d = prob["d"]
    x0 = torch.zeros(d, dtype=torch.float64, device="cuda")
    h_new, h_old = prob["hess"](x0), prob["hess"](prob["xstar"])

    def k1():
        return diff_topk_payload(h_new, h_old, k=8)

    out = {"k1_ms": time_cuda(k1),
           "k1_device_ms": device_ms(k1, "diff_topk_payload_kernel")}

    # K2's kernels: one accumulate_kernel a call before the sort-based
    # redesign, else accum_* (3 per sort pass, and one sum); the launches
    # per call as the profiler records them
    src = (Path(root) / "src/repro_torch/csrc/scatter_accum.cu").read_text()
    k2_kernel = ("accum_" if "accum_sum_kernel" in src
                 else "accumulate_kernel<double>")

    def k2_timed(key, vals, idx, shape, symmetric, reps=50):
        def call():
            return scatter_accumulate(vals, idx, shape, symmetric=symmetric)

        out[f"{key}_ms"] = time_cuda(call, reps=reps)
        split = device_per_call(call, (k2_kernel,), reps=min(reps, 20))
        out[f"{key}_device_ms"] = split["device_ms"][k2_kernel]
        out[f"{key}_launches_per_call"] = split["launches"][k2_kernel]
        out[f"{key}_profile_complete"] = split["complete"]

    diff = h_new - h_old
    for key, family in (("k2_w8a", "topk"), ("k2_w8a_sym", "topk-sym")):
        pay = make_compressor(family, d).compress(diff)
        k2_timed(key, pay.values.contiguous(), pay.indices.contiguous(),
                 (d, d), family == "topk-sym")
    bv, bi, _ = diff_topk_payload(h_new, h_old, k=8)
    grid = (-(-d // 128),) * 2

    def k4():
        return block_scatter_accumulate(bv, bi, grid, 128)

    out.update({"k4_w8a_ms": time_cuda(k4),
                "k4_w8a_device_ms": device_ms(k4, "block_scatter_kernel")})
    pay = k3_payloads(torch.device("cuda"), seed=3)
    k2_timed("k2_k3", pay.values, pay.indices, (K3_D, K3_D), False, reps=10)
    del pay, diff

    for family, level in (("topk", d), ("topk-sym", d), ("blocktopk", 8)):
        for option in (1, 2):
            alg = FedNL(prob["grad"], prob["hess"],
                        make_compressor(family, level), option=option,
                        mu=1e-3)
            state = alg.init(x0, prob["n"])
            times = []
            for _ in range(22):
                ms, state = host_ms(lambda: alg.step(state))
                times.append(ms)
            out[f"round_ms_{family}_option{option}"] = statistics.median(
                times[2:])
    del prob, h_new, h_old

    # the refresh's embed tensor: 4 x (151936, 896) f32 against one H
    gen = torch.Generator(device="cuda").manual_seed(0)
    obs = torch.randn((4, 151936, 896), generator=gen, device="cuda") * 1e-2
    h = torch.randn((151936, 896), generator=gen, device="cuda") * 1e-2
    grid = (151936 // 128, 896 // 128)
    vals, idx, _ = diff_topk_payload(obs, h, 2048, 128)
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
