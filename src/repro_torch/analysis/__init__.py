"""``repro_torch.analysis`` — static enforcement of the data-path
invariants, counterpart of ``src/repro/analysis``.

The port's claims — the uplink is dense-free end to end, every kernel
launch fits a block's shared memory and registers, ``-1`` payload padding
never aliases a real index, f64 numerics are never silently downcast, the
hot paths never read a tensor on the host — each become a ``Rule`` over a
recorded program: every registered method step, ``Compressor.aggregate``
path, kernel wrapper config, the curvature learner and the fednl train
step run once on small CPU tensors under a recorder of aten ops
(``trace_utils``; no card needed), and a registry of rules, mirroring the
engine's method and compressor registries, walks the record.

Entry points:

  check(fn, *args, rules=..., context=...)   one-line pytest assertion
  analyze(...)                               full registry sweep
  python -m repro_torch.launch.analyze       CLI (text/JSON)

Rules self-register in ``rules.py`` / ``source_rules.py`` (imported
here so the registry is populated on package import).
"""

from . import rules as _rules, source_rules as _source_rules  # noqa: F401
from .framework import (
    AnalysisError,
    Rule,
    Target,
    Violation,
    available_rules,
    check,
    get_rule,
    register_rule,
)
from .reporters import render_json, render_text
from .targets import analyze, iter_targets

__all__ = [
    "AnalysisError",
    "Rule",
    "Target",
    "Violation",
    "analyze",
    "available_rules",
    "check",
    "get_rule",
    "iter_targets",
    "register_rule",
    "render_json",
    "render_text",
]
