"""Batched serving demo on the PyTorch port: prefill a batch of prompts
and decode with the KV/state caches. Runs any of the ten architectures
(reduced configs), on the card unless given ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch xlstm-350m
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import generate


def serve(arch: str, *, batch: int = 4, prompt_len: int = 24, gen: int = 24,
          device=None):
    """``generate`` on the reduced ``arch``; prints the first two
    requests' token ids and returns every sequence."""
    seqs = generate(arch, smoke=True, batch=batch, prompt_len=prompt_len,
                    gen=gen, device=device)
    for i in range(min(2, batch)):
        print(f"request {i}: {seqs[i].tolist()}")
    return seqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
