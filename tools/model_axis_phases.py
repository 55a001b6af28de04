"""``chip_smoke.py``'s model-axis phases alone, on one card.

    python3 tools/model_axis_phases.py [--phases 16,16b,16c,16d,16e,16f,16g] \\
        [--seed 0] [--out FILE]

builds the kernels from ``src/repro_torch/csrc`` as the smoke run does,
then runs the named phases of ``chip_smoke.py`` (16: starcoder2-15b, 16b:
the MoE family, 16c: MLA, 16d: the hybrid family, 16e: xLSTM, 16f:
whisper and llava, ranks played by threads on the card; 16g: Hutchinson
curvature, rank processes on the card joined by gloo), each with the
checks it makes in the smoke run, and prints each phase's JSON line, its
launches and its seconds. For iterating on one phase without the whole
run of about 17 minutes; the smoke run stays the check. ``--out FILE``
also writes a last JSON line of the phases' seconds and launches there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

PHASES = {"16": smoke.model_axis_starcoder2_15b, "16b": smoke.model_axis_moe,
          "16c": smoke.model_axis_mla, "16d": smoke.model_axis_hybrid,
          "16e": smoke.model_axis_ssm, "16f": smoke.model_axis_encdec_vlm,
          "16g": smoke.model_axis_hvp}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    names = args.phases.split(",")
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}; known {list(PHASES)}")
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch.kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"# card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    K.build_all()
    rep = {"card": card, "build_s": time.perf_counter() - t0, "phases": {}}
    for name in names:
        t0 = time.perf_counter()
        try:
            out = PHASES[name](K, card, dev, args.seed)
        except smoke.SmokeFailure as exc:
            print(f"# phase {name} FAILED: {exc}", flush=True)
            return 1
        launches = out[0] if isinstance(out, tuple) else out
        rep["phases"][name] = {"s": time.perf_counter() - t0,
                               "launches": launches}
        print(f"# phase {name} in {rep['phases'][name]['s']:.1f} s; "
              f"launches {json.dumps(launches)}", flush=True)
        torch.cuda.empty_cache()
    line = json.dumps({"model_axis_phases": rep})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
