"""Rule protocol, rule registry, and the ``check`` entry point,
counterpart of ``src/repro/analysis/framework.py``.

A ``Rule`` inspects one recorded program (a ``trace_utils.Trace``) in the
context of one ``Target`` and returns ``Violation``s. Rules self-register
in a string-keyed registry, so the CLI and tests select them by name
(``--rule smem-budget``, ``check(fn, x, rules=["no-host-sync"])``).

Source-level rules (kind "source") receive a file path instead of a
trace — same registry, same reporting.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from .trace_utils import trace


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule violation at one site of one target."""

    rule: str
    target: str
    message: str
    site: Optional[str] = None  # op summary / file:line

    def __str__(self) -> str:
        loc = f" [{self.site}]" if self.site else ""
        return f"{self.target}: {self.rule}: {self.message}{loc}"


@dataclasses.dataclass(frozen=True)
class Target:
    """One analyzable program.

    name:    stable identifier ("method:fednl[topk]", "kernel:...")
    kind:    "method-step" | "aggregate" | "kernel" | "precond" |
             "train-step" | "source"
    trace:   zero-arg callable that runs the program under the recorder
             and returns its ``Trace`` (lazy: listing targets costs
             nothing); "source" targets return the file path instead
    rules:   rule names that apply to this target
    context: rule parameters (silo axis n, dense_shape, block, ... and
             why a rule was left off, where one was)
    """

    name: str
    kind: str
    trace: Callable[[], Any]
    rules: tuple
    context: dict = dataclasses.field(default_factory=dict)


class Rule:
    """Base class: subclass, set ``name``/``description``, implement
    ``check(traced, target) -> list[Violation]`` where ``traced`` is the
    target's ``trace()`` output (a ``Trace`` for trace rules, a file path
    for source rules). Register with ``@register_rule``."""

    name: str = ""
    description: str = ""
    kinds: tuple = ()  # target kinds this rule understands ((): any)

    def check(self, traced, target: Target) -> list:
        raise NotImplementedError

    def violation(self, target: Target, message: str,
                  site: Optional[str] = None) -> Violation:
        return Violation(rule=self.name, target=target.name,
                         message=message, site=site)


_RULES: dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: instantiate and register under ``cls.name``
    (re-registration overwrites)."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    _RULES[inst.name] = inst
    return cls


def available_rules() -> list:
    return sorted(_RULES)


def get_rule(name: str) -> Rule:
    try:
        return _RULES[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; available: {available_rules()}"
        ) from None


def rule_descriptions() -> dict:
    return {name: _RULES[name].description for name in available_rules()}


class AnalysisError(AssertionError):
    """Raised by ``check`` when a recorded program violates a rule."""

    def __init__(self, violations: Sequence[Violation]):
        self.violations = list(violations)
        lines = "\n".join(f"  - {v}" for v in self.violations)
        super().__init__(
            f"{len(self.violations)} static-analysis violation(s):\n{lines}")


def run_rules(target: Target, traced=None) -> list:
    """Trace ``target`` once (unless ``traced`` is given) and run its
    rules."""
    traced = target.trace() if traced is None else traced
    out = []
    for rname in target.rules:
        rule = get_rule(rname)
        if rule.kinds and target.kind not in rule.kinds:
            continue
        out.extend(rule.check(traced, target))
    return out


def check(fn, *args, rules, name: Optional[str] = None, kind: str = "check",
          context: Optional[dict] = None, raise_on_violation: bool = True,
          **kwargs) -> list:
    """One-line pytest integration: run ``fn(*args, **kwargs)`` under the
    recorder and assert the given rules hold.

        analysis.check(lambda g: opt.update(g, state, params), grads,
                       rules=["no-dense-roundtrip"], context={"block": 128})

    ``args`` are small CPU tensors (the program runs once). Returns the
    violations (empty on success); raises ``AnalysisError`` unless
    ``raise_on_violation`` is False.
    """
    for rname in rules:
        get_rule(rname)  # an unknown rule is an error before any work
    target = Target(
        name=name or getattr(fn, "__name__", "check"),
        kind=kind,
        trace=lambda: trace(fn, *args, **kwargs),
        rules=tuple(rules),
        context=dict(context or {}),
    )
    violations = run_rules(target)
    if violations and raise_on_violation:
        raise AnalysisError(violations)
    return violations
