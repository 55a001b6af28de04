"""Target enumeration, counterpart of ``src/repro/analysis/targets.py``:
the port's registries as the analyzable surface.

Five recorded families plus one source-level family (the reference's
names, so the two sweeps line up target for target):

  method:<name>[<comp>]   one ``step`` of every registered method, for
                          every compressor family (Newton references
                          once, with their dense wire)
  aggregate:<comp>        ``Compressor.aggregate`` over a stacked payload,
                          and the two cross-device server paths
  kernel:<pkg>:<op>       every kernel package's ``analysis_targets()``
  precond:update[...]     the fednl_precond step (single tensor, silos)
  train-step:fednl[...]   the whole fednl train step on a reduced real
                          architecture, refresh included
  source:repro_torch/<p>  every module under ``src/repro_torch``

Each target runs once on small CPU tensors under the recorder
(``trace_utils``). Everything is lazy: listing targets costs nothing.

Host-side work the port keeps on purpose is exempt, as the reference
exempts dense-wire families: a method's round draws come from a CPU
generator on the host (``RoundDraws``; the reference splits its key in
the program), so they run unrecorded; and the host loops listed in
``HOST_LOOPS`` drop ``no-host-sync`` with their reason in the target's
context.
"""

from __future__ import annotations

import importlib
import pathlib
from typing import Iterator, Optional, Sequence

import torch

from .framework import Target, Violation, get_rule
from .trace_utils import paused, trace

_N_SILOS = 3
_DIM = 16

# The smallest config each factory takes (the reference's list);
# "fednl-cohort" and "ns" get theirs in ``_method_targets``.
_METHOD_PARAMS = {
    "fednl-pp": {"tau": 2},
    "fednl-cr": {"l_star": 1.0},
    "fednl-bc": {"model_compressor": ("topk", 5), "p": 0.9, "option": 1,
                 "mu": 1e-3},
    "fednl-ppbc": {"model_compressor": ("topk", 5), "tau": 2},
}

# Representative level per compressor family (the factory knob).
_COMPRESSOR_LEVELS = {
    "topk": 5, "topksym": 5, "randk": 5, "rankr": 1, "powersgd": 1,
    "blocktopk": 4, "blocktopkthreshold": 4, "dithering": 4,
    "natural": 0.5, "identity": None, "zero": None,
}

# Families whose payload already carries one slot per entry: their
# aggregate is a dense mean by design (the reference's ``wire_is_dense``).
DENSE_WIRE = ("dithering", "identity", "natural")

# Host loops the port keeps on purpose (ROADMAP, "Semantics the port keeps
# on purpose"): the step reads a tensor on the host by design, so
# ``no-host-sync`` does not apply to it.
HOST_LOOPS = {
    "fednl-ls": "backtracking line search: a host loop that stops at the "
                "first accepted step",
    "n0-ls": "backtracking line search: a host loop that stops at the "
             "first accepted step",
}

_KERNEL_PACKAGES = ("block_topk", "scatter_accum", "hess_update",
                    "tiled_matmul", "flash_attention", "tuning")

_TRACE_RULES = ("no-host-sync", "padding-sentinel")

# Modules that DEFINE the deprecated wire-cost accessors (and their
# WireReport implementation) — excluded from the source sweep.
_SOURCE_ALLOWLIST = ("core/compressors.py", "wire/report.py")

_FLOAT = torch.float64


def _oracles(n: int, d: int):
    """Synthetic quadratic oracles in the paper's federated form: silo i
    holds f_i(x) = c_i/2 ||x||^2, so gradients stack to (n, d) and
    Hessians to (n, d, d) — enough structure for every method to run."""
    from ..engine.method import Oracles

    coef = torch.arange(1, n + 1, dtype=_FLOAT) / n

    def value(x):
        return 0.5 * torch.mean(coef) * torch.sum(x * x)

    def grad(x):
        return coef[:, None] * x[None, :]

    def hess(x):
        eye = torch.eye(d, dtype=x.dtype)
        return coef[:, None, None] * eye[None]

    return Oracles(value, grad, hess)


def _compressor_families() -> list:
    """One name per family: spelling aliases share a factory and are
    reported once, under the name the reference uses."""
    from ..core.compressors import _REGISTRY

    seen = {}
    for name in sorted(_REGISTRY, key=lambda n: (n not in _COMPRESSOR_LEVELS,
                                                 n)):
        seen.setdefault(id(_REGISTRY[name]), name)
    return sorted(seen.values())


def _make_comp(name):
    from ..core.compressors import make_compressor

    return make_compressor(name, _COMPRESSOR_LEVELS.get(name, 5))


class _HostDraws:
    """A method's round-draw source whose draws run unrecorded: they are
    host-side by design (a CPU generator), not part of the step."""

    def __init__(self, seed: int = 0):
        from ..engine.method import RoundDraws

        self._draws = RoundDraws(seed)

    def __getattr__(self, name):
        fn = getattr(self._draws, name)

        def run(*args, **kwargs):
            with paused():
                return fn(*args, **kwargs)

        return run


def _method_targets() -> Iterator[Target]:
    from ..engine.method import available_methods, make_method

    n, d = _N_SILOS, _DIM
    orc = _oracles(n, d)

    def one(mname, cname, comp):
        params = dict(_METHOD_PARAMS.get(mname, {}))
        if mname == "fednl-cohort":
            from ..core.cohort import CohortSpec

            params["cohort"] = CohortSpec(cohort=2, population=n)
        if mname == "ns":
            params["h_fixed"] = torch.eye(d, dtype=_FLOAT)

        def run():
            method = make_method(mname, orc, comp, **params)
            x0 = torch.linspace(-1.0, 1.0, d, dtype=_FLOAT)
            if comp is None:
                state = method.init(x0, n)
            else:
                state = method.init(x0, n, draws=_HostDraws(0))
            return trace(method.step, state)

        rules = _TRACE_RULES + ("dtype-discipline",)
        context = {"silo_axis": n, "dense_shape": (d, d)}
        if mname in HOST_LOOPS:
            rules = tuple(r for r in rules if r != "no-host-sync")
            context["exempt"] = {"no-host-sync": HOST_LOOPS[mname]}
        if comp is not None and cname not in DENSE_WIRE:
            rules = rules + ("no-dense-silo-stack",)
        label = f"method:{mname}[{cname}]" if comp is not None \
            else f"method:{mname}"
        return Target(name=label, kind="method-step", trace=run, rules=rules,
                      context=context)

    families = _compressor_families()
    for mname in available_methods():
        if mname in ("newton", "n0", "n0-ls", "ns"):
            # Newton references: no compressor, dense wire by definition
            yield one(mname, "", None)
        else:
            for cname in families:
                yield one(mname, cname, _make_comp(cname))


def _stacked_payload(comp, n, shape):
    from ..engine.method import RoundDraws

    m = torch.linspace(-1.0, 1.0, n * shape[0] * shape[1],
                       dtype=_FLOAT).reshape((n,) + tuple(shape))
    m = m + m.transpose(1, 2)   # symmetric, as a Hessian difference is
    return comp.apply(m, RoundDraws(0).silos(comp, n, shape, _FLOAT))


def _aggregate_targets() -> Iterator[Target]:
    n, shape = _N_SILOS, (_DIM, _DIM)
    for cname in _compressor_families():
        comp = _make_comp(cname)

        def run(comp=comp):
            pay = _stacked_payload(comp, n, shape)
            return trace(lambda p: comp.aggregate(p, shape), pay)

        rules = _TRACE_RULES
        if cname not in DENSE_WIRE:
            rules = rules + ("no-dense-silo-stack",)
        yield Target(name=f"aggregate:{cname}", kind="aggregate", trace=run,
                     rules=rules,
                     context={"silo_axis": n, "dense_shape": shape})

    # The cross-device server paths: ``streamed-slab`` is one slab of the
    # streamed server sum (K2 seeded with the running accumulator), and
    # ``sharded-window`` one rank's row window of the sharded accumulator
    # (every window in turn, one process, no collectives). Both keep the
    # payload -> ONE dense accumulator discipline and price their K2
    # launches, so they carry both rules on top of the baseline set.
    path_rules = _TRACE_RULES + ("no-dense-silo-stack", "smem-budget")
    path_ctx = {"silo_axis": n, "dense_shape": shape}

    def pairs():
        g = torch.Generator().manual_seed(0)
        vals = torch.randn((n, 5), generator=g, dtype=_FLOAT)
        r = torch.randint(0, shape[0], (n, 5), generator=g)
        c = torch.randint(0, shape[1], (n, 5), generator=g)
        idx = (torch.maximum(r, c) * shape[1] + torch.minimum(r, c))
        idx[0, 0] = -1
        return vals, idx.to(torch.int32)

    def trace_streamed():
        from ..kernels.scatter_accum import streamed_slab_update

        acc = torch.zeros(shape, dtype=_FLOAT)
        return trace(lambda a, v, i: streamed_slab_update(a, v, i, shape),
                     acc, *pairs())

    def trace_sharded():
        from ..kernels.scatter_accum.sharded import windowed_scatter_accumulate

        return trace(lambda v, i: windowed_scatter_accumulate(
            v, i, shape, 1, symmetric=True), *pairs())

    yield Target(name="aggregate:streamed-slab", kind="aggregate",
                 trace=trace_streamed, rules=path_rules,
                 context=dict(path_ctx))
    yield Target(name="aggregate:sharded-window", kind="aggregate",
                 trace=trace_sharded, rules=path_rules,
                 context=dict(path_ctx))


def _kernel_targets() -> Iterator[Target]:
    for pkg in _KERNEL_PACKAGES:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}")
        for spec in mod.analysis_targets():
            rules = _TRACE_RULES + ("smem-budget",)
            if "block" in spec.get("context", {}):
                rules = rules + ("no-dense-roundtrip",)
            yield Target(name=f"kernel:{pkg}:{spec['name']}", kind="kernel",
                         trace=spec["trace"], rules=rules,
                         context=dict(spec.get("context", {})))


def _precond_targets() -> Iterator[Target]:
    """The fednl_precond step — mixed precision by design (f32 curvature
    state), so the dtype rule does not apply; the dense-free payload path
    and the kernels' budget do."""
    from ..second_order.fednl_precond import FedNLPrecondOptimizer

    d, block = 256, 128
    opt = FedNLPrecondOptimizer(lr=0.1, k_per_block=32, block=block)
    rules = _TRACE_RULES + ("no-dense-roundtrip", "smem-budget",
                            "no-dense-silo-stack")
    ctx = {"block": block, "silo_axis": _N_SILOS, "dense_shape": (d, d)}

    def inputs():
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn((d, d), generator=g)}
        grads = {"w": torch.randn((d, d), generator=g)}
        return grads, opt.init(params), params

    def trace_single():
        grads, state, params = inputs()
        return trace(lambda g, s, p: opt.update(g, s, p), grads, state,
                     params)

    def trace_silo():
        grads, state, params = inputs()
        obs = {"w": torch.rand((_N_SILOS, d, d),
                               generator=torch.Generator().manual_seed(1))}
        return trace(lambda g, s, p, o: opt.update(g, s, p, observations=o),
                     grads, state, params, obs)

    yield Target(name="precond:update[single]", kind="precond",
                 trace=trace_single, rules=rules, context=dict(ctx))
    yield Target(name="precond:update[silo]", kind="precond",
                 trace=trace_silo, rules=rules, context=dict(ctx))


def _train_step_targets() -> Iterator[Target]:
    """The fednl train step end to end on a reduced real architecture: the
    curvature phase (per-silo gradients, fused diff payloads, the
    payload-space mean) on a refresh step and the preconditioned update —
    the program ``launch/train.py`` runs. Mixed precision by design (f32
    curvature over the model's params), with no f64 anywhere, so the
    dtype rule's f64 ban applies cleanly."""
    from ..configs import get_config
    from ..launch.steps import make_optimizer, make_train_step
    from ..models import build_model

    block, n_silos = 128, 2
    rules = _TRACE_RULES + ("no-dense-roundtrip", "dtype-discipline",
                            "smem-budget", "no-dense-silo-stack")

    def one(name, hvp, curvature):
        def run():
            cfg = get_config("qwen2-0.5b", smoke=True)
            model = build_model(cfg, use_remat=True)
            opt = make_optimizer("fednl", 1e-3, k_per_block=32, block=block,
                                 curvature=curvature)
            step = make_train_step(model, opt, refresh_every=4,
                                   n_silos=n_silos, hvp=hvp)
            params = model.init_params(torch.Generator().manual_seed(0))
            state = opt.init(params)
            g = torch.Generator().manual_seed(1)
            b, t = 4, 32
            batch = {"tokens": torch.randint(0, cfg.vocab, (b, t),
                                             generator=g),
                     "targets": torch.randint(0, cfg.vocab, (b, t),
                                              generator=g)}
            # the batch is closed over, not a program input: token ids
            # index the embedding but are no payload stream (no -1 pad)
            return trace(lambda p, s: step(p, s, batch), params, state)

        return Target(name=name, kind="train-step", trace=run, rules=rules,
                      context={"block": block, "silo_axis": n_silos})

    yield one("train-step:fednl[fisher]", False, "fisher")
    yield one("train-step:fednl[hvp]", True, "hutchinson")


def _source_targets() -> Iterator[Target]:
    root = pathlib.Path(__file__).resolve().parents[1]  # src/repro_torch
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel in _SOURCE_ALLOWLIST or rel.startswith("analysis/"):
            continue
        yield Target(name=f"source:repro_torch/{rel}", kind="source",
                     trace=lambda p=path: p,
                     rules=("no-deprecated-accessor",), context={})


_KIND_BUILDERS = {
    "method-step": _method_targets,
    "aggregate": _aggregate_targets,
    "kernel": _kernel_targets,
    "precond": _precond_targets,
    "train-step": _train_step_targets,
    "source": _source_targets,
}

KINDS = tuple(_KIND_BUILDERS)


def iter_targets(kinds: Optional[Sequence[str]] = None) -> list:
    """Enumerate all analyzable targets (lazy: free to list)."""
    out = []
    for kind, builder in _KIND_BUILDERS.items():
        if kinds is not None and kind not in kinds:
            continue
        out.extend(builder())
    return out


def analyze_target(t: Target, rules: Optional[Sequence[str]] = None) -> list:
    """Run ``t`` once and its rules (those in ``rules`` when given). A
    target whose run fails reports an ``analysis-error`` violation."""
    active = [r for r in t.rules if rules is None or r in rules]
    try:
        traced = t.trace()
        found = []
        for rname in active:
            rule = get_rule(rname)
            if rule.kinds and t.kind not in rule.kinds:
                continue
            found.extend(rule.check(traced, t))
    except Exception as e:  # noqa: BLE001 — reported, not swallowed
        found = [Violation(rule="analysis-error", target=t.name,
                           message=f"{type(e).__name__}: {e}")]
    return found


def analyze(rules: Optional[Sequence[str]] = None,
            targets: Optional[Sequence[str]] = None,
            kinds: Optional[Sequence[str]] = None) -> list:
    """Run the sweep: ``[(target, [violations]), ...]`` over every
    enumerated target (filtered by rule name / target-name substring /
    kind). A target whose run fails contributes an ``analysis-error``
    violation — a broken registry entry fails the sweep loudly."""
    results = []
    for t in iter_targets(kinds):
        if targets is not None and not any(s in t.name for s in targets):
            continue
        if not [r for r in t.rules if rules is None or r in rules]:
            continue
        results.append((t, analyze_target(t, rules)))
    return results
