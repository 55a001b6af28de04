"""Source-level (AST) rules, counterpart of
``src/repro/analysis/source_rules.py`` — same registry and reporting as
the trace rules, but the target gives a file path instead of a trace.

  no-deprecated-accessor   keeps the deprecated wire-cost quartet
                           (``comp.bits(shape)``, ``comp.spec(...).bits``,
                           ``payload_bits(...)``, ``payload.bits(...)``)
                           out of ``src/repro_torch`` — internal code goes
                           through ``repro_torch.wire.wire_cost``; the
                           aliases stay
                           only for external users. Also flags the old
                           hand-composed participation weighting
                           ``.aggregate(scale_payload(...), ...)`` —
                           weights are an ``aggregate`` kwarg now.
"""

from __future__ import annotations

import ast

from .framework import Rule, Target, register_rule


@register_rule
class NoDeprecatedAccessor(Rule):
    """Flag internal use of the deprecated wire-cost quartet.

    Patterns (exactly the quartet, nothing looser — ``cell.bits`` on a
    record cell is a different, live field and must not trip this):

      * a *call* of a ``.bits`` attribute — ``comp.bits((d, d))`` and
        ``payload.bits(index_coding=...)``
      * ``.bits`` read off a ``.spec(...)`` call — ``comp.spec(s).bits``
      * any Load of the name ``payload_bits`` (re-export ImportFrom
        aliases are ast.alias nodes, not Names, so ``__init__``
        re-exports pass)
      * ``.aggregate(...)`` whose first argument is a
        ``scale_payload(...)`` call — the pre-redesign participation
        weighting; pass ``weights=`` to ``aggregate`` instead (the
        standalone ``scale_payload`` stays fine for payload-level uses
        that never reach an aggregate)

    The defining modules (``core/compressors.py``, ``wire/report.py``)
    are excluded by the target builder, not here.
    """

    name = "no-deprecated-accessor"
    description = ("internal code uses wire_cost, not the deprecated "
                   "bits/spec().bits/payload_bits/payload.bits quartet; "
                   "participation weighting goes through "
                   "aggregate(weights=), not aggregate(scale_payload())")
    kinds = ("source",)

    def check(self, path, target: Target):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        tree = ast.parse(src, filename=str(path))
        out = []

        def flag(node, what):
            out.append(self.violation(
                target,
                f"deprecated wire-cost accessor `{what}` — use "
                "repro_torch.wire.wire_cost (WireReport) instead",
                f"{path}:{node.lineno}"))

        def is_scale_payload(call) -> bool:
            if not isinstance(call, ast.Call):
                return False
            f = call.func
            return ((isinstance(f, ast.Name) and f.id == "scale_payload")
                    or (isinstance(f, ast.Attribute)
                        and f.attr == "scale_payload"))

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr == "bits":
                    flag(node, ".bits(...)")
                elif (isinstance(fn, ast.Attribute)
                      and fn.attr == "aggregate"
                      and node.args and is_scale_payload(node.args[0])):
                    out.append(self.violation(
                        target,
                        "hand-composed `.aggregate(scale_payload(...))` "
                        "— pass the per-silo weights via "
                        "aggregate(..., weights=w) instead",
                        f"{path}:{node.lineno}"))
            elif isinstance(node, ast.Attribute) and node.attr == "bits":
                val = node.value
                if (isinstance(val, ast.Call)
                        and isinstance(val.func, ast.Attribute)
                        and val.func.attr == "spec"):
                    flag(node, ".spec(...).bits")
            elif (isinstance(node, ast.Name)
                  and node.id == "payload_bits"
                  and isinstance(node.ctx, ast.Load)):
                flag(node, "payload_bits")
        return out
