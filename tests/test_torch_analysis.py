"""The port's static analysis (``repro_torch.analysis``), test for test
against ``tests/test_analysis.py``: every rule flags its deliberately
broken torch fixture (and ONLY that rule fires), every documented
legitimate pattern passes, and the full registry sweep is violation-free
(one case per target).

Parity with the reference: the port's targets are the reference's under
a stated mapping (``_port_name``), rule sets included; on the fixtures
below the reference's rules, run on the JAX counterparts, give the same
verdicts (the reference's Pallas kernel verdicts are not compared: its
``vmem-budget`` reads a BlockMapping field jax 0.9.0 lacks). The CLI
runs in process.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch import analysis
from repro_torch.analysis import Target, get_rule
from repro_torch.analysis.targets import HOST_LOOPS, analyze_target
from repro_torch.analysis.trace_utils import call_kernel
from repro_torch.core.compressors import Compressor, TopK
from repro_torch.kernels import resources
from repro_torch.kernels.call_sites import CALL_SITES

_ALL_TRACE_RULES = ["no-dense-silo-stack", "no-dense-roundtrip",
                    "dtype-discipline", "no-host-sync",
                    "padding-sentinel", "smem-budget"]


def _only(violations, rule):
    """The fixture is flagged by exactly the intended rule."""
    assert violations, f"expected {rule} to fire"
    assert {v.rule for v in violations} == {rule}


# -- framework ----------------------------------------------------------------


def test_check_raises_analysis_error_with_violations():
    def bad(x):
        print("x =", float(x.sum()))  # a host read of a device value
        return x * 2

    with pytest.raises(analysis.AnalysisError) as ei:
        analysis.check(bad, torch.ones(4), rules=["no-host-sync"])
    assert ei.value.violations
    assert "no-host-sync" in str(ei.value)


def test_unknown_rule_is_a_loud_error():
    with pytest.raises(KeyError, match="unknown rule"):
        analysis.check(lambda x: x, torch.ones(3), rules=["no-such-rule"])


def test_rules_registered():
    for name in _ALL_TRACE_RULES + ["no-deprecated-accessor"]:
        assert name in analysis.available_rules()
        assert get_rule(name).description
    assert "vmem-budget" not in analysis.available_rules()


# -- no-dense-silo-stack ------------------------------------------------------


def _stacked_payload(comp, n, shape):
    m = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n,) + shape))
    return comp.compress(m)


def test_dense_decompress_then_mean_aggregate_is_flagged():
    """The generic ``Compressor.aggregate`` decompresses each silo and
    means the (n, d, d) stack — exactly what the rule keeps out of the
    registered fast paths."""
    comp = TopK(k=5)
    n, shape = 3, (16, 16)
    pay = _stacked_payload(comp, n, shape)
    violations = analysis.check(
        lambda p: Compressor.aggregate(comp, p, shape), pay,
        rules=_ALL_TRACE_RULES, kind="aggregate",
        context={"silo_axis": n, "dense_shape": shape},
        raise_on_violation=False)
    _only(violations, "no-dense-silo-stack")


def test_payload_space_aggregate_passes():
    comp = TopK(k=5)
    n, shape = 3, (16, 16)
    pay = _stacked_payload(comp, n, shape)
    analysis.check(lambda p: comp.aggregate(p, shape), pay,
                   rules=_ALL_TRACE_RULES, kind="aggregate",
                   context={"silo_axis": n, "dense_shape": shape})


def test_silo_stack_reduction_in_step_is_flagged():
    """Outside aggregate targets the rule flags (n, d, d) -> (d, d)
    reductions (decompress-then-mean server math), while (n, d, d)
    tensors themselves stay legal."""
    n, d = 3, 16

    def bad_step(h_stack):
        return torch.mean(h_stack, dim=0)  # the server's dense mean

    violations = analysis.check(
        bad_step, torch.ones((n, d, d)), rules=["no-dense-silo-stack"],
        kind="method-step", context={"silo_axis": n, "dense_shape": (d, d)},
        raise_on_violation=False)
    _only(violations, "no-dense-silo-stack")

    def ok_step(h_stack):
        return h_stack * 2.0 + 1.0  # per-silo state update: legal

    analysis.check(ok_step, torch.ones((n, d, d)),
                   rules=["no-dense-silo-stack"], kind="method-step",
                   context={"silo_axis": n, "dense_shape": (d, d)})


# -- no-dense-roundtrip -------------------------------------------------------


def test_blocksq_intermediate_is_flagged():
    block = 8

    def bad(tiles):  # dense (nblocks, block^2) selection mask
        return torch.abs(tiles.reshape(4, block * block))

    violations = analysis.check(bad, torch.ones((16, block * block // 4)),
                                rules=_ALL_TRACE_RULES,
                                context={"block": block},
                                raise_on_violation=False)
    _only(violations, "no-dense-roundtrip")


# -- dtype-discipline ---------------------------------------------------------


def test_f64_laundered_through_f32_is_flagged():
    def bad(x):
        y = x.to(torch.float32)  # silent precision loss
        return (y * 2.0).to(torch.float64)  # laundered back

    violations = analysis.check(bad, torch.ones(8, dtype=torch.float64),
                                rules=_ALL_TRACE_RULES,
                                raise_on_violation=False)
    _only(violations, "dtype-discipline")


def test_selection_only_downcast_passes():
    """BlockTopKThreshold's documented pattern: f32 is fine for selecting
    indices (the taint dies at the int boundary) as long as the selected
    values come from the f64 original."""
    def ok(x):
        score = torch.abs(x).to(torch.float32)
        idx = torch.topk(score, 3).indices
        return x[idx]  # values stay f64 end to end

    analysis.check(ok, torch.ones(8, dtype=torch.float64),
                   rules=_ALL_TRACE_RULES)


# -- no-host-sync -------------------------------------------------------------


def test_host_read_is_flagged():
    def bad(x):
        if bool(x[0] > 0):  # the host waits for the device
            return x + 1
        return x

    violations = analysis.check(bad, torch.ones(4), rules=_ALL_TRACE_RULES,
                                raise_on_violation=False)
    _only(violations, "no-host-sync")


def test_data_dependent_shape_is_flagged():
    def bad(x):
        return x[x > 0]  # a boolean mask sizes the output

    violations = analysis.check(bad, torch.ones(4), rules=_ALL_TRACE_RULES,
                                raise_on_violation=False)
    _only(violations, "no-host-sync")


# -- padding-sentinel ---------------------------------------------------------


def test_unremapped_negative_index_scatter_is_flagged():
    """A payload index stream fed straight into ``index_put_``: -1 wraps
    to the last slot, so the padding silently lands there — the rule
    must catch it."""
    n = 16

    def bad(vals, idx):
        return torch.zeros(n, dtype=vals.dtype).index_put_(
            (idx,), vals, accumulate=True)

    violations = analysis.check(
        bad, torch.ones(4), torch.tensor([0, 3, -1, 5]),
        rules=_ALL_TRACE_RULES, raise_on_violation=False)
    _only(violations, "padding-sentinel")


def test_remapped_scatter_passes():
    n = 16

    def ok(vals, idx):
        idx = torch.where(idx < 0, n, idx)  # the pad to a spare slot FIRST
        acc = torch.zeros(n + 1, dtype=vals.dtype).index_put_(
            (idx,), vals, accumulate=True)
        return acc[:n]

    analysis.check(ok, torch.ones(4), torch.tensor([0, 3, -1, 5]),
                   rules=_ALL_TRACE_RULES)


def test_in_trace_topk_indices_pass():
    """Indices born from topk inside the program cannot be -1: no remap
    required."""
    def ok(x):
        v, idx = torch.topk(x, 3)
        return torch.zeros_like(x).index_put_((idx,), v, accumulate=True)

    analysis.check(ok, torch.arange(8.0), rules=_ALL_TRACE_RULES)


# -- smem-budget --------------------------------------------------------------


def _attention(q):
    return call_kernel("flash_attention", q, q, q, bq=128, bk=128)


def test_over_budget_launch_is_flagged(monkeypatch):
    """A launch over a block's budget is caught on the CPU: K9's FFMA
    kernel at hd 128 and 128 x 128 tiles takes 198,144 bytes of shared
    memory, over a 64 KiB budget; and a build at 257 registers a thread
    would need 65,792 of the SM's 65,536 for its 256 threads."""
    q = torch.ones((1, 8, 1, 128))
    violations = analysis.check(_attention, q, rules=_ALL_TRACE_RULES,
                                context={"smem_budget": 64 * 1024},
                                raise_on_violation=False)
    _only(violations, "smem-budget")
    monkeypatch.setitem(resources.BUILD,
                        "flash_attention_kernel<float, 128, 128, 128>",
                        (257, 0))
    violations = analysis.check(_attention, q, rules=_ALL_TRACE_RULES,
                                raise_on_violation=False)
    _only(violations, "smem-budget")


def test_within_budget_launch_passes():
    analysis.check(_attention, torch.ones((1, 8, 1, 128)),
                   rules=_ALL_TRACE_RULES)


# -- no-deprecated-accessor (source rule) -------------------------------------


def _run_source_rule(tmp_path, text):
    p = tmp_path / "fixture.py"
    p.write_text(text)
    t = Target(name="fixture", kind="source", trace=lambda: p,
               rules=("no-deprecated-accessor",))
    return get_rule("no-deprecated-accessor").check(p, t)


def test_deprecated_accessors_are_flagged(tmp_path):
    violations = _run_source_rule(tmp_path, (
        "def f(comp, payload):\n"
        "    a = comp.bits((4, 4))\n"
        "    b = comp.spec((4, 4)).bits\n"
        "    c = payload_bits(comp, (4, 4))\n"
        "    d = payload.bits(index_coding='entropy')\n"
        "    return a + b + c + d\n"))
    assert len(violations) == 4
    assert {v.rule for v in violations} == {"no-deprecated-accessor"}


def test_live_bits_fields_and_reexports_pass(tmp_path):
    """``cell.bits`` (a live record field) and ``payload_bits`` re-export
    imports do NOT trip the rule — only the quartet's usage patterns
    do."""
    violations = _run_source_rule(tmp_path, (
        "from repro_torch.core.compressors import payload_bits\n"
        "__all__ = ['payload_bits']\n"
        "def f(cell):\n"
        "    return cell.bits[0] + float(cell.bits[-1])\n"))
    assert violations == []


# -- the registry sweep pin ---------------------------------------------------


_TARGETS = analysis.iter_targets()


def test_full_registry_sweep_enumerates_the_world():
    """The sweep lists every target kind at the reference's counts (the
    source kind counts the port's own files)."""
    kinds = {}
    for t in _TARGETS:
        kinds[t.kind] = kinds.get(t.kind, 0) + 1
    assert {k: v for k, v in kinds.items() if k != "source"} == {
        "method-step": 92, "aggregate": 13, "kernel": 15, "precond": 2,
        "train-step": 2}
    assert kinds["source"] > 80


@pytest.mark.parametrize("target", _TARGETS, ids=[t.name for t in _TARGETS])
def test_full_registry_sweep_has_zero_violations(target):
    """The acceptance criterion as a test, one case per target: every
    method x compressor step, aggregate path, kernel config, the precond
    path, the train step and the source sweep — zero violations. A target
    whose run breaks surfaces as an ``analysis-error`` violation."""
    assert [str(v) for v in analyze_target(target)] == []


def test_train_step_targets_registered():
    """The full fednl train step (fisher AND hvp curvature) is a sweep
    target carrying every trace rule."""
    targets = analysis.iter_targets(["train-step"])
    names = {t.name for t in targets}
    assert names == {"train-step:fednl[fisher]", "train-step:fednl[hvp]"}
    for t in targets:
        assert t.kind == "train-step"
        for rule in ("no-dense-silo-stack", "no-dense-roundtrip",
                     "dtype-discipline", "smem-budget"):
            assert rule in t.rules, (t.name, rule)
        assert t.context["block"] == 128


# -- exemptions, parity, the CLI ----------------------------------------------


def test_host_loop_exemptions_are_pinned():
    """``no-host-sync`` is left off exactly the methods whose step is a
    host loop by design (``HOST_LOOPS``, each with its reason), and each
    of them does read the device on the host — an exemption that no
    longer needs to be made fails here."""
    assert set(HOST_LOOPS) == {"fednl-ls", "n0-ls"}
    exempt = [t for t in _TARGETS if t.kind == "method-step"
              and "no-host-sync" not in t.rules]
    assert {t.name.split("[")[0] for t in exempt} == {"method:fednl-ls",
                                                      "method:n0-ls"}
    for t in exempt:
        assert t.context["exempt"]["no-host-sync"]
    for t in [exempt[0], exempt[-1]]:
        tr = t.trace()
        assert any(op.packet == "aten._local_scalar_dense" for op in tr.ops)


def _port_name(ref_name: str) -> str:
    """The stated mapping from a reference target name to the port's."""
    if ref_name.startswith("source:repro/"):
        return "source:repro_torch/" + ref_name[len("source:repro/"):]
    return {"kernel:tuning:scatter_accumulate[default:single-block,c512]":
            "kernel:tuning:scatter_accumulate[default:512x512,k=512,n=4]",
            "kernel:tuning:scatter_accumulate[default:(512,512),c512]":
            "kernel:tuning:scatter_accumulate[default:4096x4096,k=2048,n=4]",
            }.get(ref_name, ref_name)


def test_target_names_and_rules_match_reference():
    """Every reference target has its port counterpart with the same kind
    and rules (``vmem-budget`` -> ``smem-budget``), except the reference's
    Pallas ``kernel.py`` sources, which the port has no file for; K9's
    name keeps the reference's tiles, which are the port's defaults."""
    from repro.analysis import iter_targets as jax_iter_targets

    port = {t.name: t for t in _TARGETS}
    missing = []
    for t in jax_iter_targets():
        name = _port_name(t.name)
        if name.endswith("/kernel.py"):
            continue   # Pallas bodies: csrc/*.cu in the port
        if name not in port:
            missing.append(name)
            continue
        want = tuple("smem-budget" if r == "vmem-budget" else r
                     for r in t.rules)
        if t.kind == "method-step" and t.name.split("[")[0] in (
                "method:fednl-ls", "method:n0-ls"):
            want = tuple(r for r in want if r != "no-host-sync")
        assert port[name].kind == t.kind, name
        assert sorted(port[name].rules) == sorted(want), name
    # the reference's sources the port has no counterpart for yet
    assert missing == [], missing


def _jax_fixtures():
    import jax
    import jax.numpy as jnp

    n = 16

    def scatter_bad(vals, idx):
        return jnp.zeros((n,), vals.dtype).at[idx].add(vals, mode="drop")

    def scatter_ok(vals, idx):
        idx = jnp.where(idx < 0, n, idx)
        return jnp.zeros((n,), vals.dtype).at[idx].add(vals, mode="drop")

    def launder(x):
        return (x.astype(jnp.float32) * 2.0).astype(jnp.float64)

    def select(x):
        _, idx = jax.lax.top_k(jnp.abs(x).astype(jnp.float32), 3)
        return x[idx]

    def mean_stack(h):
        return jnp.mean(h, axis=0)

    def blocksq(t):
        return jnp.abs(t.reshape(4, 64))

    i = jnp.zeros(4, jnp.int32)
    return {
        "padding-sentinel:bad": (scatter_bad, (jnp.ones(4), i), {}),
        "padding-sentinel:ok": (scatter_ok, (jnp.ones(4), i), {}),
        "dtype-discipline:bad": (launder, (jnp.ones(8, jnp.float64),), {}),
        "dtype-discipline:ok": (select, (jnp.ones(8, jnp.float64),), {}),
        "no-dense-silo-stack:bad": (mean_stack, (jnp.ones((3, 16, 16)),),
                                    {"silo_axis": 3, "dense_shape": (16, 16)}),
        "no-dense-roundtrip:bad": (blocksq, (jnp.ones((16, 16)),),
                                   {"block": 8}),
    }


def _torch_fixtures():
    n = 16

    def scatter_bad(vals, idx):
        return torch.zeros(n, dtype=vals.dtype).index_put_(
            (idx,), vals, accumulate=True)

    def scatter_ok(vals, idx):
        idx = torch.where(idx < 0, n, idx)
        return torch.zeros(n + 1, dtype=vals.dtype).index_put_(
            (idx,), vals, accumulate=True)[:n]

    def launder(x):
        return (x.to(torch.float32) * 2.0).to(torch.float64)

    def select(x):
        return x[torch.topk(torch.abs(x).to(torch.float32), 3).indices]

    def mean_stack(h):
        return torch.mean(h, dim=0)

    def blocksq(t):
        return torch.abs(t.reshape(4, 64))

    i = torch.zeros(4, dtype=torch.int64)
    f64 = torch.ones(8, dtype=torch.float64)
    return {
        "padding-sentinel:bad": (scatter_bad, (torch.ones(4), i)),
        "padding-sentinel:ok": (scatter_ok, (torch.ones(4), i)),
        "dtype-discipline:bad": (launder, (f64,)),
        "dtype-discipline:ok": (select, (f64,)),
        "no-dense-silo-stack:bad": (mean_stack, (torch.ones((3, 16, 16)),)),
        "no-dense-roundtrip:bad": (blocksq, (torch.ones((16, 16)),)),
    }


_JAX_RULES = ["no-dense-silo-stack", "no-dense-roundtrip",
              "dtype-discipline", "no-host-sync", "padding-sentinel"]


# The reference misjudges its own remap on jax 0.9.0 (its
# test_remapped_scatter_passes fails: ``jnp.where`` now traces inside a
# ``jit`` scope its slicer does not enter), so that fixture is held to the
# verdict the reference documents, not to the one it gives.
_REFERENCE_BROKEN = {"padding-sentinel:ok"}


@pytest.mark.parametrize("case", sorted(_torch_fixtures()))
def test_fixture_verdicts_match_reference(case):
    """The reference's rules on the JAX fixture and the port's on its torch
    counterpart flag the same rules (none for a legitimate pattern)."""
    import jax
    from repro import analysis as jax_analysis

    kind = "method-step"
    with jax.enable_x64(True):
        jfn, jargs, ctx = _jax_fixtures()[case]
        want = {v.rule for v in jax_analysis.check(
            jfn, *jargs, rules=_JAX_RULES, kind=kind, context=ctx,
            raise_on_violation=False)}
    tfn, targs = _torch_fixtures()[case]
    got = {v.rule for v in analysis.check(
        tfn, *targs, rules=_JAX_RULES, kind=kind, context=ctx,
        raise_on_violation=False)}
    if case not in _REFERENCE_BROKEN:
        assert got == want
    assert (case.endswith(":bad")) == bool(got)
    assert got <= {case.split(":")[0]}


def test_every_wrapper_import_is_a_call_site():
    """A module that imports a kernel wrapper by name calls it through its
    own global, which only ``CALL_SITES`` swaps: every such import in
    ``src/repro_torch`` is listed, or the recorder (and the dry run's
    counts) would miss its calls."""
    import ast
    import pathlib

    import repro_torch

    root = pathlib.Path(repro_torch.__file__).parent
    missing = []
    for path in sorted(root.rglob("*.py")):
        module = "repro_torch." + ".".join(
            path.relative_to(root).with_suffix("").parts)
        module = module.removesuffix(".__init__")
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.ImportFrom):
                continue
            for alias in node.names:
                name = alias.asname or alias.name
                if alias.name in CALL_SITES and name == alias.name \
                        and "kernels" in (node.module or "kernels") \
                        and module not in CALL_SITES[alias.name]:
                    missing.append((module, alias.name))
    assert missing == []


def test_cli_in_process(capsys, monkeypatch):
    """``python -m repro_torch.launch.analyze``: exit 0 on the port with
    the count by kind beside the reference's 208; ``--json -`` parses;
    a planted violation (K9's FFMA kernel built over the register
    budget) exits nonzero."""
    from repro_torch.launch.analyze import main

    assert main([]) == 0
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "total" in out and "/208" in out
    assert main(["--kind", "aggregate", "--json", "-"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{"):])
    assert doc["num_targets"] == 13 and doc["num_violations"] == 0
    assert main(["--list", "--kind", "kernel"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 15
    monkeypatch.setitem(resources.BUILD,
                        "flash_attention_kernel<float, 64, 128, 128>",
                        (257, 0))
    assert main(["--kind", "kernel", "--target", "flash_attention"]) == 1
    assert "smem-budget" in capsys.readouterr().out
