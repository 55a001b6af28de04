"""Where the port calls each kernel wrapper: the modules that hold it
under its own name. ``swapped`` replaces wrappers at every such site for
a stand-in and restores them after — how ``launch/dryrun.py`` counts a
kernel's work on the meta device and how ``analysis/trace_utils.py``
records a kernel as one opaque op. A module that starts calling a wrapper
belongs here, or those two miss its calls."""

from __future__ import annotations

import contextlib
import importlib

CALL_SITES = {
    "diff_topk_payload": ("repro_torch.kernels.block_topk",
                          "repro_torch.core.compressors",
                          "repro_torch.second_order.fednl_precond"),
    "block_topk_payload": ("repro_torch.kernels.block_topk",
                           "repro_torch.core.compressors"),
    "block_topk": ("repro_torch.kernels.block_topk",),
    "scatter_accumulate": ("repro_torch.kernels.scatter_accum",
                           "repro_torch.kernels.scatter_accum.ops",
                           "repro_torch.kernels.scatter_accum.sharded",
                           "repro_torch.core.compressors"),
    "block_scatter_accumulate": ("repro_torch.kernels.scatter_accum",
                                 "repro_torch.core.compressors"),
    "hess_update": ("repro_torch.kernels.hess_update",),
    "tiled_matmul": ("repro_torch.kernels.tiled_matmul",
                     "repro_torch.kernels.tiled_matmul.ops"),
    "flash_attention": ("repro_torch.kernels.flash_attention",
                        "repro_torch.models.attention"),
}


def wrapper(name: str):
    """The wrapper ``name`` as its own package holds it now (the stand-in
    while ``swapped`` is active)."""
    return getattr(importlib.import_module(CALL_SITES[name][0]), name)


@contextlib.contextmanager
def swapped(stand_ins: dict):
    """Inside the block, every call site of each wrapper named in
    ``stand_ins`` calls ``stand_ins[name](original, *args, **kwargs)``,
    where ``original`` is the wrapper itself. Restored on exit."""
    saved = []
    try:
        for name, make in stand_ins.items():
            original = wrapper(name)

            def stand_in(*args, _make=make, _original=original, **kwargs):
                return _make(_original, *args, **kwargs)

            for path in CALL_SITES[name]:
                mod = importlib.import_module(path)
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, stand_in)
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
