"""Payload-space server sums: ``scatter_accumulate`` (SparsePayload,
global flat indices) and ``block_scatter_accumulate`` (BlockSparsePayload,
in-tile indices), each the dense SUM over silos from one accumulator.

On a CUDA tensor each launches its kernel in ``csrc/scatter_accum.cu``;
on a CPU tensor it runs the plain version in ``ref.py``. There is no
other path: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .ref import block_scatter_accumulate_ref, scatter_accumulate_ref

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_pairs(name: str, values, indices, ndim: int) -> None:
    if values.device.type != "cuda" or indices.device != values.device:
        raise ValueError(f"{name}: values and indices must lie on one CUDA "
                         f"device, got {values.device} and {indices.device}")
    if values.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32/float64, got {values.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 indices, got {indices.dtype}")
    if values.dim() != ndim or values.shape != indices.shape:
        raise ValueError(f"{name}: expected values and indices of one "
                         f"{ndim}-d shape, got {tuple(values.shape)} and "
                         f"{tuple(indices.shape)}")
    if not (values.is_contiguous() and indices.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")


def scatter_accumulate(values: torch.Tensor, indices: torch.Tensor, shape,
                       symmetric: bool = False,
                       init: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (d0, d1) SUM of n silos' (value, row-major flat index)
    pairs, values/indices (n, k). Indices outside the matrix (-1
    padding) are dropped, duplicates add, ``symmetric`` mirrors each
    off-diagonal pair, ``init`` seeds the sum. Each cell adds its pairs
    in stream order (silo, slot), with no float atomics."""
    d0, d1 = (int(s) for s in shape)
    if values.device.type == "cpu" and indices.device.type == "cpu":
        return scatter_accumulate_ref(values, indices, (d0, d1),
                                      symmetric=symmetric, init=init)
    _check_pairs("scatter_accumulate", values, indices, 2)
    if init is not None and (init.shape != (d0, d1) or init.dtype != values.dtype
                             or init.device != values.device
                             or not init.is_contiguous()):
        raise ValueError("scatter_accumulate: init must be a contiguous "
                         f"({d0}, {d1}) tensor like values")
    if d0 * d1 >= 2**31:
        raise ValueError(f"scatter_accumulate: ({d0}, {d1}) has more cells "
                         "than int32 flat indices address")
    n, k = values.shape
    out = torch.empty((d0, d1), dtype=values.dtype, device=values.device)
    fn = getattr(_cuda.library("scatter_accum"),
                 f"scatter_accumulate_{_SUFFIX[values.dtype]}")
    with _cuda.on(values.device):
        err = fn(values.data_ptr(), indices.data_ptr(),
                 None if init is None else init.data_ptr(), out.data_ptr(),
                 n, k, d0, d1, int(bool(symmetric)), _cuda.stream())
    _cuda.check(err, "scatter_accumulate")
    _cuda.LAUNCHES["scatter_accumulate"] += 1
    return out


def block_scatter_accumulate(values: torch.Tensor, indices: torch.Tensor,
                             grid, block: int) -> torch.Tensor:
    """Dense (gm * block, gn * block) SUM of n block-sparse silo payloads,
    values/indices (n, gm * gn, k) in the BlockSparsePayload layout."""
    gm, gn = (int(g) for g in grid)
    if values.device.type == "cpu" and indices.device.type == "cpu":
        return block_scatter_accumulate_ref(values, indices, (gm, gn), block)
    _check_pairs("block_scatter_accumulate", values, indices, 3)
    n, nblk, k = values.shape
    if nblk != gm * gn:
        raise ValueError(f"block_scatter_accumulate: {nblk} tiles for a "
                         f"{gm} x {gn} grid")
    out = torch.empty((gm * block, gn * block), dtype=values.dtype,
                      device=values.device)
    fn = getattr(_cuda.library("scatter_accum"),
                 f"block_scatter_accumulate_{_SUFFIX[values.dtype]}")
    with _cuda.on(values.device):
        err = fn(values.data_ptr(), indices.data_ptr(), out.data_ptr(), n,
                 nblk, k, block, gn, _cuda.stream())
    _cuda.check(err, "block_scatter_accumulate")
    _cuda.LAUNCHES["block_scatter_accumulate"] += 1
    return out
