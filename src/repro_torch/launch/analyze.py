"""``python -m repro_torch.launch.analyze`` — the static-analysis sweep,
counterpart of ``src/repro/launch/analyze.py``.

Runs every registered method step, ``Compressor.aggregate`` path, kernel
wrapper config, the fednl_precond step and the fednl train step on a
reduced real architecture once on small CPU tensors under the recorder
(plus an AST pass over ``src/repro_torch``) and checks the data-path
invariants. CPU only: it needs no card. Nonzero exit on any violation.

  python -m repro_torch.launch.analyze                  # full sweep
  python -m repro_torch.launch.analyze --list           # enumerate targets
  python -m repro_torch.launch.analyze --rules          # describe the rules
  python -m repro_torch.launch.analyze --rule smem-budget --kind kernel
  python -m repro_torch.launch.analyze --json report.json
"""

from __future__ import annotations

import argparse
import collections
import sys

# The reference's sweep on jax 0.9.0: 208 targets by kind
# (``repro.analysis.iter_targets()``).
REFERENCE_TARGETS = {"method-step": 92, "aggregate": 13, "kernel": 15,
                     "precond": 2, "train-step": 2, "source": 84}


def main(argv=None) -> int:
    from ..analysis.targets import KINDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze",
        description="static analysis of the recorded data paths")
    ap.add_argument("--rule", action="append", dest="rules", metavar="NAME",
                    help="only run this rule (repeatable)")
    ap.add_argument("--target", action="append", dest="targets",
                    metavar="SUBSTR",
                    help="only targets whose name contains SUBSTR "
                         "(repeatable)")
    ap.add_argument("--kind", action="append", dest="kinds", choices=KINDS,
                    help="only targets of this kind (repeatable)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the JSON report to PATH ('-' for "
                         "stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list targets (with their rules) and exit")
    ap.add_argument("--rules", action="store_true", dest="describe_rules",
                    help="list registered rules and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print passing targets too")
    args = ap.parse_args(argv)

    from ..analysis import iter_targets
    from ..analysis.framework import get_rule, rule_descriptions
    from ..analysis.reporters import render_json, render_text
    from ..analysis.targets import analyze

    if args.describe_rules:
        for name, desc in rule_descriptions().items():
            print(f"{name:24s} {desc}")
        return 0

    if args.rules:
        for r in args.rules:
            get_rule(r)  # fail fast on typos

    if args.list:
        for t in iter_targets(args.kinds):
            if args.targets and not any(s in t.name for s in args.targets):
                continue
            print(f"{t.kind:12s} {t.name}  ({', '.join(t.rules)})")
        return 0

    results = analyze(rules=args.rules, targets=args.targets,
                      kinds=args.kinds)
    print(render_text(results, verbose=args.verbose))
    by_kind = collections.Counter(t.kind for t, _ in results)
    print("targets by kind (port / reference): " + ", ".join(
        f"{k} {by_kind.get(k, 0)}/{REFERENCE_TARGETS[k]}" for k in KINDS)
        + f"; total {len(results)}/{sum(REFERENCE_TARGETS.values())}")
    if args.json:
        payload = render_json(results)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(payload + "\n")
    return 1 if any(v for _, v in results) else 0


if __name__ == "__main__":
    sys.exit(main())
