"""The trace rule set, counterpart of ``src/repro/analysis/rules.py``:
the reference's six jaxpr rules re-expressed over recorded aten ops, with
``smem-budget`` in place of ``vmem-budget``.

  no-dense-silo-stack   the server never materializes / reduces an
                        (n, d, d) decompressed silo stack
  no-dense-roundtrip    the payload path never builds a block^2-trailing
                        dense mask or scatter round-trip, nor a forbidden
                        dense shape, outside kernel records
  dtype-discipline      no f64 value is silently narrowed and then fed
                        back into an f64 result (or into the program
                        output)
  no-host-sync          no ``.item()``/``bool()``/``float()`` of a tensor
                        (``aten._local_scalar_dense``) and no op whose
                        output shape depends on the data, on the path
  padding-sentinel      every op that WRAPS a negative index remaps the
                        -1 payload padding before it
  smem-budget           every kernel record's launches fit a block's
                        shared memory (227 KB) and the SM's registers

Ops inside a kernel record (``in_kernel``: the plain version standing in
for the kernel on the CPU) are what the card does in the kernel, and the
data-path rules skip them, as the reference skips ``pallas_call`` bodies.
"""

from __future__ import annotations

import torch

from .framework import Rule, Target, register_rule
from .trace_utils import KERNEL_PREFIX, Trace

# ops that reduce a stack into one matrix, or multiply one down
_REDUCING = ("aten.sum", "aten.mean", "aten.prod", "aten.amax", "aten.amin",
             "aten.bmm", "aten.mm", "aten.matmul", "aten.einsum",
             "aten.addbmm", "aten.baddbmm", "aten.nansum", "aten.std",
             "aten.var")


def _host_ops(tr: Trace):
    """The ops the card runs outside kernels: every aten op that is not
    inside a kernel record."""
    return (op for op in tr.ops if not op.in_kernel and not op.is_kernel)


@register_rule
class NoDenseSiloStack(Rule):
    """No dense (n, d, d) silo stack on the server path.

    On ``aggregate`` targets no op may emit an (n, d, d) tensor at all —
    the fast paths go from payload space to ONE dense accumulator.
    Dense-wire families (Identity, Natural, Dithering) are exempted by
    the target builder. On every other kind (n, d, d) tensors are
    legitimate state (stacked Hessians, per-silo H_i), so the rule flags
    a reduction (sum, mean, bmm, matmul, einsum, ...) of an (n, d, d)
    input into a (d, d) output: the decompress-then-mean server sum.
    """

    name = "no-dense-silo-stack"
    description = ("server aggregation stays in payload space: no "
                   "(n, d, d) decompressed stack is built or reduced")

    def check(self, tr: Trace, target: Target):
        n = target.context.get("silo_axis")
        dense = tuple(target.context.get("dense_shape", ()))
        if not n or not dense:
            return []
        stack = (int(n),) + dense
        out = []
        for op in _host_ops(tr):
            if target.kind != "aggregate":
                if op.packet in _REDUCING and any(
                        t.shape == stack for t in op.inputs) and any(
                            t.shape == dense for t in op.outputs):
                    out.append(self.violation(
                        target,
                        f"dense reduction of the {stack} silo stack into "
                        f"{dense} — server aggregation must stay in "
                        "payload space", op.describe()))
            else:
                for t in op.outputs:
                    if t.shape == stack:
                        out.append(self.violation(
                            target,
                            f"materializes the dense {stack} silo stack "
                            "(decompress-then-mean path)", op.describe()))
        return out


@register_rule
class NoDenseRoundtrip(Rule):
    """No tensor with a block^2 trailing dim outside kernel records —
    neither the dense per-tile selection mask nor the dense scatter
    round-trip — and no tensor of the ``dense_forbidden`` shape (the
    full difference a fused diff -> payload kernel keeps out of device
    memory)."""

    name = "no-dense-roundtrip"
    description = ("the payload compression path never materializes a "
                   "block^2-trailing-dim dense tile intermediate outside "
                   "kernel records")

    def check(self, tr: Trace, target: Target):
        block = int(target.context.get("block", 0))
        forbidden = tuple(target.context.get("dense_forbidden", ()))
        if not block and not forbidden:
            return []
        bb = block * block
        out = []
        for op in _host_ops(tr):
            for t in op.outputs:
                if block and t.shape and t.shape[-1] == bb:
                    out.append(self.violation(
                        target,
                        f"dense block^2={bb} trailing-dim intermediate "
                        "(selection mask / per-tile scatter round-trip)",
                        op.describe()))
                elif forbidden and t.shape == forbidden:
                    out.append(self.violation(
                        target,
                        f"dense {forbidden} intermediate on a fused "
                        "diff->payload path (the difference must stay "
                        "inside the kernel)", op.describe()))
        return out


_NARROW_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_CASTS = ("aten._to_copy", "aten.to", "aten._to_dtype")


@register_rule
class DtypeDiscipline(Rule):
    """No silent f64 -> narrow-float downcast that re-enters an f64
    result. A cast (``_to_copy``/``to``) from f64 to f32/f16/bf16 taints
    its output; the taint follows every op to its float outputs and dies
    at int and bool outputs (narrowing for *selection* — comparisons,
    indices — is fine). An op with a tainted input and an f64 output
    (an explicit cast back, or type promotion) is precision laundering,
    and so is a tainted program output."""

    name = "dtype-discipline"
    description = ("no silent f64->f32 downcast re-entering an f64 result "
                   "or reaching the program output")

    def check(self, tr: Trace, target: Target):
        tainted = set()
        out = []
        for op in _host_ops(tr):
            ins = op.inputs
            hot = any(t.key in tainted for t in ins)
            if op.packet in _CASTS and ins:
                src = ins[0].dtype
                dst = op.outputs[0].dtype if op.outputs else None
                if src == torch.float64 and dst in _NARROW_FLOATS:
                    tainted.add(op.outputs[0].key)
                    continue
            if not hot:
                continue
            if any(t.dtype == torch.float64 for t in op.outputs):
                out.append(self.violation(
                    target,
                    "f64 value silently downcast and brought back into an "
                    "f64 result (precision laundering)", op.describe()))
                continue
            for t in op.outputs:
                if t.dtype in _NARROW_FLOATS:
                    tainted.add(t.key)
        for t in tr.outputs:
            if t.key in tainted:
                out.append(self.violation(
                    target,
                    f"program output is an f64 value silently downcast to "
                    f"{str(t.dtype).removeprefix('torch.')}",
                    f"output {t.describe()}"))
        return out


# ops whose output shape depends on the values of their input
_DATA_DEPENDENT = ("aten.nonzero", "aten.nonzero_static", "aten.masked_select",
                   "aten.unique", "aten._unique", "aten._unique2",
                   "aten.unique_dim", "aten.unique_consecutive",
                   "aten.argwhere")


@register_rule
class NoHostSync(Rule):
    """No host round trip on the path: ``aten._local_scalar_dense``
    (what ``.item()``, ``bool()``, ``int()`` and ``float()`` of a tensor
    run) waits for the device and copies to the host, and an op whose
    output shape depends on the data (``nonzero``, ``masked_select``,
    ``unique``, indexing by a boolean mask) must do the same to size its
    output. Either serializes the step. Host loops the port keeps on
    purpose are exempted by the target builder, with the reason in the
    target's context."""

    name = "no-host-sync"
    description = ("no .item()/bool()/float() of a tensor and no "
                   "data-dependent output shape on the path")

    def check(self, tr: Trace, target: Target):
        out = []
        for op in _host_ops(tr):
            if op.packet == "aten._local_scalar_dense":
                out.append(self.violation(
                    target, "tensor read on the host (.item(), bool(), "
                    "float(), int()) — a device sync", op.describe()))
            elif op.packet in _DATA_DEPENDENT:
                out.append(self.violation(
                    target, f"`{op.packet}` has a data-dependent output "
                    "shape — a device sync", op.describe()))
            elif op.packet == "aten.index" and any(
                    t.dtype in (torch.bool, torch.uint8)
                    for t in op.inputs[1:]):
                out.append(self.violation(
                    target, "indexing by a boolean mask has a "
                    "data-dependent output shape — a device sync",
                    op.describe()))
        return out


class _Slicer:
    """Backward slice over index dataflow: whether a tensor provably
    cannot carry an unremapped negative payload index."""

    TRANSPARENT = ("aten.view", "aten._unsafe_view", "aten.reshape",
                   "aten.expand", "aten.squeeze", "aten.unsqueeze",
                   "aten.permute", "aten.transpose", "aten.t", "aten.slice",
                   "aten.select", "aten.clone", "aten.contiguous",
                   "aten._to_copy", "aten.to", "aten.flatten", "aten.alias",
                   "aten.detach", "aten.lift_fresh", "aten.lift_fresh_copy",
                   "aten.index", "aten.gather", "aten.index_select",
                   "aten.repeat", "aten.repeat_interleave", "aten.flip",
                   "aten.roll", "aten.narrow", "aten.copy", "aten.copy_",
                   "aten.split", "aten.split_with_sizes", "aten.chunk",
                   "aten.unbind", "aten.as_strided", "aten._reshape_alias")
    SAFE_SOURCES = ("aten.arange", "aten.topk", "aten.sort", "aten.argsort",
                    "aten.argmax", "aten.argmin", "aten.cumsum",
                    "aten.randperm", "aten.randint", "aten.multinomial",
                    "aten.nonzero", "aten.bucketize", "aten.searchsorted",
                    "aten.bernoulli", "aten.rand", "aten.randn",
                    "aten.histc", "aten.bincount", "aten.abs")
    SANITIZERS = ("aten.where", "aten.clamp", "aten.clamp_", "aten.clip",
                  "aten.masked_fill", "aten.masked_fill_")
    COMBINING = ("aten.add", "aten.sub", "aten.rsub", "aten.mul", "aten.div",
                 "aten.remainder", "aten.fmod", "aten.neg", "aten.cat",
                 "aten.stack", "aten.minimum", "aten.min", "aten.floor_divide",
                 "aten.bitwise_and", "aten.bitwise_or", "aten.__and__",
                 "aten.__or__", "aten.add_", "aten.mul_", "aten.sub_",
                 "aten.div_")

    def __init__(self, tr: Trace):
        self.tr = tr
        self.inputs = tr.input_keys()
        self.seen: set = set()

    def _constant_nonneg(self, t) -> bool:
        prod = self.tr.producer.get(t.key)
        if prod is not None and prod.inputs:
            return False
        v = self.tr.values.get(t.key)
        return v is not None and bool((v >= 0).all())

    def safe(self, t) -> bool:
        if t.key in self.seen:
            return True  # diamond or cycle: already being checked
        self.seen.add(t.key)
        if t.key in self.inputs or (t.base is not None
                                    and t.base in self.inputs):
            return False  # a payload index stream from outside: may be -1
        prod = self.tr.producer.get(t.key)
        if prod is None and t.base is not None:
            prod = self.tr.producer.get(t.base)
        if prod is None:
            return True   # made before the program ran: a constant
        if prod.is_kernel:
            return False  # a kernel's payload indices carry -1 padding
        name = prod.packet
        if not prod.inputs or name in self.SAFE_SOURCES \
                or name in self.SANITIZERS:
            return True   # a factory constant, an index born here, a remap
        if name in ("aten.maximum", "aten.max", "aten.clamp_min",
                    "aten.clamp_min_"):
            # max(i, c) with a non-negative constant clamps the padding
            if name.startswith("aten.clamp_min") and prod.scalars and all(
                    isinstance(c, (int, float)) and c >= 0
                    for c in prod.scalars):
                return True
            if any(self._constant_nonneg(o) for o in prod.inputs):
                return True
            return all(self.safe(o) for o in prod.inputs)
        if name in self.TRANSPARENT:
            return self.safe(prod.inputs[0])
        if name in self.COMBINING:
            return all(self.safe(o) for o in prod.inputs)
        return False  # unknown producer of an index stream


@register_rule
class PaddingSentinel(Rule):
    """Every op that WRAPS a negative index (``index_put``/``index_put_``,
    indexing, ``index_fill``, ``take``, ``put``: see
    ``trace_utils.WRAPPING_INDEX_ARG``) whose index may hold the -1
    payload padding must see it remapped first (``where``, ``clamp``,
    ``masked_fill``, ``max`` with a constant >= 0): -1 wraps to the last
    element and silently writes or reads it. Detected by a backward slice
    from the op's index to a program input or a kernel's payload indices
    with no remap in between."""

    name = "padding-sentinel"
    description = ("-1 payload padding is remapped before every op that "
                   "wraps negative indices")

    def check(self, tr: Trace, target: Target):
        out = []
        for op in _host_ops(tr):
            for t in op.indices:
                if not _Slicer(tr).safe(t):
                    out.append(self.violation(
                        target,
                        f"`{op.packet}` takes a potentially negative payload "
                        "index without remapping -1 first (a negative "
                        "index wraps to the last element)", op.describe()))
                    break
        return out


@register_rule
class SmemBudget(Rule):
    """Every kernel record's launches, priced by
    ``kernels.resources.launch_resources`` (threads, static and dynamic
    shared bytes, registers from the build), fit a block's shared memory
    (``SMEM_BUDGET_BYTES``, 227 KB on sm_90) and the SM's 65,536
    registers — checked on the CPU, so an over-budget config fails the
    analysis instead of its launch."""

    name = "smem-budget"
    description = ("every kernel launch fits 227 KB of shared memory and "
                   "65,536 registers a block")

    def check(self, tr: Trace, target: Target):
        from ..kernels import REGISTERS_PER_BLOCK, SMEM_BUDGET_BYTES
        from ..kernels.resources import launch_resources

        budget = int(target.context.get("smem_budget", SMEM_BUDGET_BYTES))
        out = []
        for op in tr.ops:
            if not op.is_kernel:
                continue
            kernel = op.name[len(KERNEL_PREFIX):]
            for lc in launch_resources(kernel, **op.params):
                if lc.smem > budget or lc.block_registers > REGISTERS_PER_BLOCK:
                    out.append(self.violation(
                        target,
                        f"kernel `{lc.kernel}` takes {lc.smem} bytes of shared "
                        f"memory and {lc.block_registers} registers a block, "
                        f"over the {budget}-byte / {REGISTERS_PER_BLOCK} "
                        "budget", op.describe()))
        return out
