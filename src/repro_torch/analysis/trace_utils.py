"""Execution traces for the analysis rules, counterpart of
``src/repro/analysis/jaxpr_utils.py``.

The reference walks the closed jaxpr of a traced program. The port's
paths have host control flow and ctypes kernel calls, which neither
``make_fx`` nor ``torch.export`` captures whole, so a target is instead
RUN once on small CPU tensors under ``Recorder``, a ``TorchDispatchMode``
that records every aten op that executes: its name, the shape, dtype and
identity of each tensor it reads and writes (a view records its base),
and its other arguments. A value's producer is the last op that wrote it,
so the rules walk dataflow backwards as the reference walks jaxpr
equations.

Kernel calls are opaque records, the counterpart of a ``pallas_call``
equation: while a trace records, every kernel wrapper is swapped at its
call sites (``kernels/call_sites.py``) for a stand-in that records one
``kernel:<name>`` op with the launch parameters the card would get, and
computes the result with the wrapper itself — on CPU tensors its plain
version — whose own ops are recorded as ``in_kernel`` (the counterpart of
ops inside a kernel body). No hook exists outside a trace: the card path
runs as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.call_sites import CALL_SITES, swapped, wrapper

KERNEL_PREFIX = "kernel:"


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """One tensor an op read or wrote: ``key`` is its identity in the
    trace, ``base`` its base's key when it is a view."""

    key: int
    shape: tuple
    dtype: torch.dtype
    base: Optional[int] = None

    def describe(self) -> str:
        return f"{str(self.dtype).removeprefix('torch.')}{list(self.shape)}"


@dataclasses.dataclass
class Op:
    """One recorded op: an aten op (``aten.<name>.<overload>``) or a
    kernel record (``kernel:<wrapper>``, with its launch ``params``)."""

    name: str
    inputs: list
    outputs: list
    scalars: list
    in_kernel: bool = False
    params: dict = dataclasses.field(default_factory=dict)
    indices: list = dataclasses.field(default_factory=list)

    @property
    def is_kernel(self) -> bool:
        return self.name.startswith(KERNEL_PREFIX)

    @property
    def packet(self) -> str:
        """The op without its overload: "aten.sum" for aten.sum.dim_IntList."""
        if self.is_kernel:
            return self.name
        parts = self.name.split(".")
        return ".".join(parts[:2])

    def describe(self) -> str:
        outs = ", ".join(t.describe() for t in self.outputs)
        return f"{self.name} -> {outs}"


@dataclasses.dataclass
class Trace:
    """What ran: ``ops`` in order, the program's ``inputs`` and
    ``outputs``, the last writer of each tensor (``producer``) and the
    tensors themselves (``values``, held so identities stay unique)."""

    ops: list
    inputs: list
    outputs: list
    producer: dict
    values: dict

    def input_keys(self) -> set:
        return {t.key for t in self.inputs}


def flatten(tree) -> list:
    """The tensors of ``tree``: tensors, lists, tuples (named ones too),
    dicts and dataclass instances, depth first."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def _scalars(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            return
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        else:
            out.append(x)

    walk(tree)
    return out


class Recorder(TorchDispatchMode):
    """Records every aten op run under it into ``ops`` (module
    docstring); ``paused`` stops it for host-side work a target builder
    exempts, ``kernel_depth`` > 0 marks ops inside a kernel stand-in."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.producer: dict = {}
        self.values: dict = {}
        self.kernel_depth = 0
        self.paused = False

    def info(self, t: torch.Tensor) -> TensorInfo:
        key = id(t)
        self.values.setdefault(key, t)
        base = t._base
        if base is not None:
            self.values.setdefault(id(base), base)
        return TensorInfo(key, tuple(t.shape), t.dtype,
                          None if base is None else id(base))

    def add(self, name: str, args, outputs, params=None,
            in_kernel: bool = False) -> Op:
        op = Op(name, [self.info(t) for t in flatten(args)],
                [self.info(t) for t in flatten(outputs)], _scalars(args),
                in_kernel, dict(params or {}))
        self.ops.append(op)
        for t in op.outputs:
            self.producer[t.key] = op
            if t.base is not None and op.packet.endswith("_"):
                self.producer[t.base] = op   # written through a view
        return op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            packet = func._overloadpacket.__name__
            op = self.add(f"aten.{packet}.{func._overloadname}",
                          (args, kwargs), out,
                          in_kernel=self.kernel_depth > 0)
            where = WRAPPING_INDEX_ARG.get(packet)
            if where is not None and len(args) > where:
                op.indices = [self.info(t) for t in flatten(args[where])
                              if not t.dtype.is_floating_point
                              and t.dtype not in (torch.bool, torch.uint8)]
        return out


# The aten ops whose integer index argument (at this position) WRAPS a
# negative index to the end, as Python indexing does: an unremapped -1
# payload pad lands on the last element. index_add_, index_select,
# index_copy_, scatter/scatter_add_/scatter_reduce_, gather, embedding and
# index_reduce_ raise on -1 instead (checked on torch 2.x's CPU ops), so a
# pad there is a loud error, not a silent write.
WRAPPING_INDEX_ARG = {"index_put": 1, "index_put_": 1, "_index_put_impl_": 1,
                      "index": 1, "index_fill": 2, "index_fill_": 2,
                      "take": 1, "put": 1, "put_": 1}

_ACTIVE: list = []  # the recorder of the trace running now, if any


def active() -> Optional[Recorder]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def paused():
    """Ops run inside are left out of the trace being recorded (a
    host-side draw, say; none is recorded outside a trace anyway)."""
    rec = active()
    was = rec is not None and rec.paused
    if rec is not None:
        rec.paused = True
    try:
        yield
    finally:
        if rec is not None:
            rec.paused = was


# -- the kernels' launch parameters -------------------------------------------


def _vec(block: int, ncols: int) -> bool:
    return block % 4 == 0 and ncols % 4 == 0


def _diff_topk_params(a, b, k, block=128, tile_sums=False):
    return dict(dtype=torch.promote_types(a.dtype, b.dtype),
                k=min(int(k), block * block), block=block,
                vec=_vec(block, a.shape[-1]), shared_b=b.dim() == 2)


def _payload_params(x, k, block=128, bisect_all=False):
    return dict(dtype=x.dtype, k=min(int(k), block * block), block=block,
                vec=_vec(block, x.shape[-1]))


def _dense_params(x, k, block=128):
    return dict(dtype=x.dtype, k=0, block=block, vec=_vec(block, x.shape[-1]))


def _scatter_params(values, indices, shape, symmetric=False, init=None,
                    log_r=None, digit_bits=None, seg=None):
    from ..kernels.scatter_accum.ops import resolve_plan

    n, k = values.shape
    d0, d1 = (int(s) for s in shape)
    return dict(dtype=values.dtype, shape=(d0, d1), n=n, k=k,
                symmetric=bool(symmetric),
                plan=resolve_plan(n, k, d0, d1, bool(symmetric),
                                  values.dtype, values.device, log_r,
                                  digit_bits, seg))


def _block_scatter_params(values, indices, grid, block):
    return dict(dtype=values.dtype, block=int(block),
                vec=values.shape[-1] % 4 == 0)


def _hess_params(h, d, s, alpha, block=None):
    from ..kernels.hess_update.ops import resolve_block

    return dict(dtype=h.dtype,
                block=resolve_block(h.shape, h.dtype, h.device, block))


def _matmul_params(a, b, chunks=None):
    from ..kernels.tiled_matmul.ops import _strided, resolve_plan

    a32 = _strided(a)
    m, k = a32.shape
    p = resolve_plan(m, b.shape[1], k, a32.stride(),
                     a32.data_ptr() % 16 == 0, a.device, chunks)
    return dict(route=p.route, chunks=p.chunks,
                layout="rows" if a32.stride()[1] == 1 else "cols")


def _flash_params(q, k, v, bq=None, bk=None, window=None):
    from ..kernels.flash_attention.ops import resolve_tiles

    _, t, h, hd = q.shape
    bq, bk = resolve_tiles(t, hd, h // k.shape[2], window, q.dtype, q.device,
                           bq, bk)
    return dict(dtype=q.dtype, hd=hd, bq=bq, bk=bk, window=window)


LAUNCH_PARAMS: dict = {
    "diff_topk_payload": _diff_topk_params,
    "block_topk_payload": _payload_params,
    "block_topk": _dense_params,
    "scatter_accumulate": _scatter_params,
    "block_scatter_accumulate": _block_scatter_params,
    "hess_update": _hess_params,
    "tiled_matmul": _matmul_params,
    "flash_attention": _flash_params,
}


def _stand_in(name: str):
    def run(original, *args, **kwargs):
        rec = active()
        if rec is None or rec.paused:
            return original(*args, **kwargs)
        params = LAUNCH_PARAMS[name](*args, **kwargs)
        rec.kernel_depth += 1
        try:
            out = original(*args, **kwargs)
        finally:
            rec.kernel_depth -= 1
        rec.add(KERNEL_PREFIX + name, (args, kwargs), out, params,
                in_kernel=rec.kernel_depth > 0)
        return out

    return run


def call_kernel(name: str, *args, **kwargs):
    """Call kernel wrapper ``name`` as its package holds it now: the
    recording stand-in inside ``trace``, the wrapper outside."""
    return wrapper(name)(*args, **kwargs)


def trace(fn: Callable, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` under a ``Recorder``, with every kernel
    wrapper swapped for its recording stand-in, and return the trace.
    ``args`` are the program's inputs; what ``fn`` returns its outputs."""
    rec = Recorder()
    inputs = [rec.info(t) for t in flatten((args, kwargs))]
    _ACTIVE.append(rec)
    try:
        with swapped({name: _stand_in(name) for name in CALL_SITES}), rec:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    outputs = [rec.info(t) for t in flatten(out)]
    return Trace(rec.ops, inputs, outputs, rec.producer, rec.values)
