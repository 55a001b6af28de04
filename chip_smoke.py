#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, all started together);
  3. hold every kernel to its plain PyTorch version on the card, in f64
     and f32, at the shapes FedNL's main path gives it on w8a;
  4. drive FedNL Options 1 and 2 on the w8a stand-in (n=142, m=350,
     d=300, f64) for Top-K (k=d), symmetric Top-K (k=d), Rank-R (1) and
     Block-Top-K (8), 20 rounds each, through ``FedNL.run``; assert the
     error bound and that every kernel of the path was launched; then
     hold the card to the CPU port on a1a-sized data;
  5. time a FedNL round per compressor, and each kernel beside its bound,
     its plain version and the nearest single PyTorch call;
  6. print the kernel line, the card line, and last the device line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 20
MU = 1e-3
# ||x^20 - x*|| of the JAX reference on its own w8a draws (x0 = 0,
# ||x0 - x*|| = 2.6326945144070444), f64 on the CPU, from
# scripts/reference_w8a_fednl.py. The port runs on other draws of the
# same shapes, so its bound is twice the reference's error scaled by the
# port's own ||x0 - x*||, and never below 1e-9 (Option 1 reaches the
# f64 round-off floor, where the reference reads 1e-15 to 1e-10).
REFERENCE_ERR0 = 2.6326945144070444
REFERENCE_ERR = {
    ("topk", 1): 6.732863620692267e-14, ("topk", 2): 0.11513699893708386,
    ("topk-sym", 1): 1.6870138221894845e-15,
    ("topk-sym", 2): 0.1073136652229507,
    ("rankr", 1): 1.4924566654577763e-12, ("rankr", 2): 0.032669316075475484,
    ("blocktopk", 1): 6.500296250558938e-11,
    ("blocktopk", 2): 0.12608646649884878,
}
LEVELS = {"topk": 300, "topk-sym": 300, "rankr": 1, "blocktopk": 8}
# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_cuda(fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time (ms) per call of the CUDA kernel whose name contains
    ``kernel``, from the profiler: ``time_cuda`` also counts the host's
    launch overhead wherever that exceeds the kernel's run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key)
    if total <= 0:
        raise RuntimeError(f"the profiler saw no kernel named like {kernel!r}")
    return total / 1e3 / reps


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs operations
    over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not at {src}")
    sys.path.insert(0, str(src))
    import repro_torch.kernels as K
    from repro_torch.core import FedNL, make_compressor
    from repro_torch.data import make_problem, problem_from_data
    from repro_torch.data.synthetic import make_libsvm_like
    from repro_torch.kernels.block_topk import diff_topk_payload, diff_topk_payload_ref
    from repro_torch.kernels.scatter_accum import (
        block_scatter_accumulate,
        block_scatter_accumulate_ref,
        scatter_accumulate,
        scatter_accumulate_ref,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        return fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = K.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")
    print(f"# build: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"diff_topk_payload": 0.0, "scatter_accumulate": 0.0,
           "block_scatter_accumulate": 0.0}

    def sym(n, d, dtype):
        m = torch.randn((n, d, d), generator=gen, device=dev, dtype=dtype)
        return 0.5 * (m + m.transpose(1, 2))

    for dtype in (torch.float64, torch.float32):
        a, b = sym(142, 300, dtype), sym(142, 300, dtype)
        a[:, :6, :6] = 9.0 * torch.sign(a[:, :6, :6])   # planted tie cluster
        b[:, :6, :6] = 0.0
        for k, block in ((8, 128), (128 * 128, 128), (40, 16)):
            got = diff_topk_payload(a, b, k=k, block=block)
            want = diff_topk_payload_ref(a, b, k=k, block=block)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                return fail(f"diff_topk_payload payload differs ({dtype}, k={k})")
            rel = float(torch.max(torch.abs(got[2] - want[2]) / want[2]))
            if rel > (1e-12 if dtype == torch.float64 else 1e-5):
                return fail(f"diff_topk_payload ||D||^2 off by {rel:.2e} rel")
            if dtype == torch.float64:
                e = float(torch.max(torch.abs(got[2] - want[2])))
                err["diff_topk_payload"] = max(err["diff_topk_payload"], e)

        def pairs(n, k, numel, symmetric):
            idx = torch.randint(0, numel, (n, k), generator=gen, device=dev)
            if symmetric:
                r, c = idx // 300, idx % 300
                idx = torch.maximum(r, c) * 300 + torch.minimum(r, c)
            idx[:, 5] = idx[:, 2]                          # duplicates
            idx[:, -7:] = -1                               # padding
            vals = torch.randn((n, k), generator=gen, device=dev, dtype=dtype)
            return vals, idx.to(torch.int32).contiguous()

        tol = 1e-12 if dtype == torch.float64 else 1e-4
        for symmetric in (False, True):
            vals, idx = pairs(142, 300, 300 * 300, symmetric)
            got = scatter_accumulate(vals, idx, (300, 300), symmetric=symmetric)
            want = scatter_accumulate_ref(vals, idx, (300, 300),
                                          symmetric=symmetric)
            e = float(torch.max(torch.abs(got - want)))
            if e > tol * max(1.0, float(torch.max(torch.abs(want)))):
                return fail(f"scatter_accumulate off by {e:.2e} ({dtype})")
            if dtype == torch.float64:
                err["scatter_accumulate"] = max(err["scatter_accumulate"], e)
            # a weight-0 silo changes nothing, bit for bit
            w = torch.ones(142, dtype=dtype, device=dev)
            w[17] = 0.0
            dropped = idx.clone()
            dropped[17] = -1
            x0 = scatter_accumulate(vals * w[:, None], idx, (300, 300),
                                    symmetric=symmetric)
            x1 = scatter_accumulate(vals, dropped, (300, 300),
                                    symmetric=symmetric)
            if not torch.equal(x0, x1):
                return fail("scatter_accumulate: a weight-0 silo changed the sum")
        init = torch.randn((300, 300), generator=gen, device=dev, dtype=dtype)
        got = scatter_accumulate(vals, idx, (300, 300), init=init)
        want = scatter_accumulate_ref(vals, idx, (300, 300), init=init)
        if float(torch.max(torch.abs(got - want))) > tol * 10:
            return fail("scatter_accumulate with init differs")
        # the output-tiled regime of the TPU (d >= 1025 in f64)
        big = torch.randint(0, 1100 * 1100, (16, 4096), generator=gen,
                            device=dev).to(torch.int32)
        bvals = torch.randn((16, 4096), generator=gen, device=dev, dtype=dtype)
        got = scatter_accumulate(bvals, big, (1100, 1100))
        want = scatter_accumulate_ref(bvals, big, (1100, 1100))
        e = float(torch.max(torch.abs(got - want)))
        if e > tol * 10:
            return fail(f"scatter_accumulate at d=1100 off by {e:.2e}")
        if dtype == torch.float64:
            err["scatter_accumulate"] = max(err["scatter_accumulate"], e)

        bi = torch.randint(0, 128 * 128, (142, 9, 8), generator=gen, device=dev)
        bi[:, :, 3] = bi[:, :, 1]
        bi[:, :, -1] = -1
        bi = bi.to(torch.int32).contiguous()
        bv = torch.randn((142, 9, 8), generator=gen, device=dev, dtype=dtype)
        got = block_scatter_accumulate(bv, bi, (3, 3), 128)
        want = block_scatter_accumulate_ref(bv, bi, (3, 3), 128)
        e = float(torch.max(torch.abs(got - want)))
        if e > tol * 10:
            return fail(f"block_scatter_accumulate off by {e:.2e} ({dtype})")
        if dtype == torch.float64:
            err["block_scatter_accumulate"] = max(err["block_scatter_accumulate"],
                                                  e)
    torch.cuda.synchronize()
    print(f"# kernels match their plain versions (f64 and f32); max abs err "
          f"in f64 {json.dumps(err)}", flush=True)

    # -- 4. the main path: FedNL on w8a -------------------------------------
    prob = make_problem("w8a", seed=0, device=dev)
    d, n = prob["d"], prob["n"]
    x0 = torch.zeros(d, dtype=torch.float64, device=dev)
    err0 = float(torch.linalg.vector_norm(x0 - prob["xstar"]))
    K.reset_launches()
    finals = {}
    t_main = time.perf_counter()
    for family, level in LEVELS.items():
        for option in (1, 2):
            alg = FedNL(prob["grad"], prob["hess"], make_compressor(family, level),
                        option=option, mu=MU)
            _, xs = alg.run(x0, n, ROUNDS)
            finals[family, option] = xs
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    t_main = time.perf_counter() - t_main
    print(f"# main path: 8 FedNL runs x {ROUNDS} rounds in {t_main:.1f} s; "
          f"launches {json.dumps(launches)}", flush=True)
    for (family, option), xs in finals.items():
        if xs.shape != (ROUNDS + 1, d) or not bool(torch.isfinite(xs).all()):
            return fail(f"{family} option {option}: non-finite or misshapen iterates")
        e = float(torch.linalg.vector_norm(xs[-1] - prob["xstar"]))
        limit = max(1e-9, 2 * REFERENCE_ERR[family, option] * err0
                    / REFERENCE_ERR0)
        print(f"# w8a {family} option {option}: ||x0-x*|| {err0:.6e} -> "
              f"||x{ROUNDS}-x*|| {e:.6e} (bound {limit:.6e})")
        if not e < limit:
            return fail(f"{family} option {option}: ||x-x*|| = {e:.3e} >= {limit}")
    for name, count in launches.items():
        if count == 0:
            return fail(f"kernel {name} was not launched on the main path")

    # the card against the CPU port (held to the JAX reference by the
    # tests) on a1a-sized data: iterates agree to 1e-8 absolute
    small = make_libsvm_like(torch.Generator().manual_seed(1), "a1a")
    p_cpu = problem_from_data(small)
    p_gpu = problem_from_data(small._replace(a=small.a.to(dev), b=small.b.to(dev)))
    for family, level in (("topk", 123), ("topk-sym", 123), ("rankr", 1),
                          ("blocktopk", 8)):
        for option in (1, 2):
            xs = []
            for p in (p_cpu, p_gpu):
                alg = FedNL(p["grad"], p["hess"], make_compressor(family, level),
                            option=option, mu=MU)
                z = torch.zeros(123, dtype=torch.float64, device=p["xstar"].device)
                xs.append(alg.run(z, 16, 12)[1].cpu())
            gap = float(torch.max(torch.abs(xs[0] - xs[1])))
            if gap > 1e-8:
                return fail(f"a1a {family} option {option}: card vs CPU gap {gap:.2e}")
    print("# a1a: card iterates match the CPU port to 1e-8", flush=True)

    # -- 5. timings -----------------------------------------------------------
    round_ms = {}
    for family, level in LEVELS.items():
        for option in (1, 2):
            alg = FedNL(prob["grad"], prob["hess"], make_compressor(family, level),
                        option=option, mu=MU)
            state = alg.init(x0, n)
            times = []
            for _ in range(8):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state = alg.step(state)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            round_ms[f"{family}/option{option}"] = statistics.median(times[2:])
    print(json.dumps({"round_ms_median": round_ms, "card": card}), flush=True)

    # where a round's device time goes: 3 rounds per compressor under the
    # profiler, the top operations by device time, and the device's busy
    # share of the rounds' wall time
    from torch.profiler import ProfilerActivity, profile

    breakdown = {}
    for family, level in LEVELS.items():
        alg = FedNL(prob["grad"], prob["hess"], make_compressor(family, level),
                    option=2, mu=MU)
        state = alg.step(alg.init(x0, n))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(3):
                state = alg.step(state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / 3
        # device-side rows only (kernels, copies); operator rows repeat them
        ops = [(e.key, e.self_device_time_total / 1e3 / 3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])
        busy = sum(ms for _, ms in ops)
        breakdown[f"{family}/option2"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_device_ms": [[name[:60], ms] for name, ms in ops[:6]]}
    print(json.dumps({"round_profile": breakdown}), flush=True)

    # main-path inputs: Hessians at x0 against Hessians at x*
    h_new = prob["hess"](x0)
    h_old = prob["hess"](prob["xstar"])
    topk = make_compressor("topk", 300).compress(h_new - h_old)
    bvals, bidx, _ = diff_topk_payload(h_new, h_old, k=8)
    nblk = bvals.shape[1]
    grid = (-(-d // 128),) * 2
    kernels = []

    # read a and b once; write k (value, index) pairs and one partial per
    # tile; 32 f32 bisection compares per padded tile entry
    b_ms, b_by = bound(2 * n * d * d * 8 + n * nblk * (8 * (8 + 4) + 8),
                       {"f64": 3 * n * d * d, "f32": 32 * n * nblk * 128 * 128})
    mags = torch.abs(h_new - h_old).reshape(n, 1, d * d)
    kernels.append(dict(
        name="diff_topk_payload", route="cuda",
        source="src/repro_torch/csrc/block_topk.cu",
        replaces="src/repro/kernels/block_topk/kernel.py:197",
        launches=launches["diff_topk_payload"],
        max_abs_err=err["diff_topk_payload"],
        ms=time_cuda(lambda: diff_topk_payload(h_new, h_old, k=8)),
        device_ms=device_ms(lambda: diff_topk_payload(h_new, h_old, k=8),
                            "diff_topk_payload_kernel<double>"),
        plain_ms=time_cuda(lambda: diff_topk_payload_ref(h_new, h_old, k=8),
                           reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        nearest_call="torch.topk(|D|, 8) per matrix, D formed beforehand",
        nearest_call_ms=time_cuda(lambda: torch.topk(mags, 8, dim=-1))))

    tv, ti = topk.values.contiguous(), topk.indices.contiguous()
    b_ms, b_by = bound(tv.numel() * 12 + d * d * 8, {"f64": tv.numel()})
    flat = torch.zeros(d * d, dtype=torch.float64, device=dev)
    ti64 = ti.reshape(-1).to(torch.int64)
    kernels.append(dict(
        name="scatter_accumulate", route="cuda",
        source="src/repro_torch/csrc/scatter_accum.cu",
        replaces="src/repro/kernels/scatter_accum/kernel.py:135",
        also_replaces="src/repro/kernels/scatter_accum/kernel.py:219",
        launches=launches["scatter_accumulate"],
        max_abs_err=err["scatter_accumulate"],
        ms=time_cuda(lambda: scatter_accumulate(tv, ti, (d, d))),
        device_ms=device_ms(lambda: scatter_accumulate(tv, ti, (d, d)),
                            "accumulate_kernel<double, false>"),
        plain_ms=time_cuda(lambda: scatter_accumulate_ref(tv, ti, (d, d))),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(lambda: flat.index_put_((ti64,), tv.reshape(-1),
                                                     accumulate=True)),
        library_call="index_put_(accumulate=True) into a flat (d*d) buffer"))

    b_ms, b_by = bound(bvals.numel() * 12 + nblk * 128 * 128 * 8,
                       {"f64": bvals.numel()})
    tiles = torch.zeros(nblk * 128 * 128, dtype=torch.float64, device=dev)
    tile_of = torch.arange(nblk, device=dev)[None, :, None] * (128 * 128)
    bflat = (bidx.to(torch.int64) + tile_of).reshape(-1)
    kernels.append(dict(
        name="block_scatter_accumulate", route="cuda",
        source="src/repro_torch/csrc/scatter_accum.cu",
        replaces="src/repro/kernels/scatter_accum/kernel.py:282",
        launches=launches["block_scatter_accumulate"],
        max_abs_err=err["block_scatter_accumulate"],
        ms=time_cuda(lambda: block_scatter_accumulate(bvals, bidx, grid, 128)),
        device_ms=device_ms(lambda: block_scatter_accumulate(bvals, bidx, grid,
                                                             128),
                            "accumulate_kernel<double, true>"),
        plain_ms=time_cuda(lambda: block_scatter_accumulate_ref(bvals, bidx,
                                                                grid, 128)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_cuda(lambda: tiles.index_put_((bflat,), bvals.reshape(-1),
                                                      accumulate=True)),
        library_call="index_put_(accumulate=True) into (tiles, block^2), "
                     "tile-major layout"))

    # -- 6. result lines ----------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
