"""Text and JSON rendering of an ``analyze`` sweep, counterpart of
``src/repro/analysis/reporters.py`` (the same formats).

The text form is the log a person reads; the JSON form is the machine
record (one entry per target with its kind, applied rules, and
violations)."""

from __future__ import annotations

import json


def render_text(results, verbose: bool = False) -> str:
    """One line per violating target (every target when ``verbose``),
    then a one-line summary."""
    lines = []
    n_viol = 0
    for target, violations in results:
        if violations:
            n_viol += len(violations)
            lines.append(f"FAIL {target.name}")
            for v in violations:
                loc = f"  [{v.site}]" if v.site else ""
                lines.append(f"     {v.rule}: {v.message}{loc}")
        elif verbose:
            lines.append(f"ok   {target.name}  ({', '.join(target.rules)})")
    lines.append(
        f"{len(results)} target(s) analyzed, {n_viol} violation(s)")
    return "\n".join(lines)


def render_json(results) -> str:
    records = []
    for target, violations in results:
        records.append({
            "target": target.name,
            "kind": target.kind,
            "rules": list(target.rules),
            "violations": [
                {"rule": v.rule, "message": v.message, "site": v.site}
                for v in violations
            ],
        })
    n_viol = sum(len(v) for _, v in results)
    return json.dumps({"targets": records,
                       "num_targets": len(results),
                       "num_violations": n_viol}, indent=2)
