"""The server accumulator sharded by rows over a mesh axis, counterpart
of ``src/repro/kernels/scatter_accum/sharded.py``.

Each rank owns a contiguous window of rows ``[rank * rows_per, (rank +
1) * rows_per)`` of the dense (d0, d1) sum and adds only the pairs that
land in it: the pair stream is the same on every rank (payloads are
small; the accumulator is what grows with d). Out-of-window pairs and
the -1 padding are remapped to -1, so a window is the ordinary
``scatter_accumulate`` (K2 on a card) at (rows_per, d1). K2 sums each
cell's pairs in stream order, so a window's cells are the unsharded
sum's cells bit for bit.

The symmetric (lower-triangular payload) sum cannot use K2's fused
mirror, whose mirror may land in another rank's window: the pairs are
mirror-expanded to (n, 2k) first, each off-diagonal entry once at
(r, c) and once at (c, r), diagonal and padding mirrors sent to -1.

``windowed_scatter_accumulate`` computes every window in turn in one
process (what each rank computes, without collectives);
``sharded_scatter_accumulate`` is the rank's own window over a
``DeviceMesh`` axis, all-gathered to the dense sum when asked. This file
imports nothing of ``launch``: the placement rule ``accumulator_spec``
lives in ``launch/sharding.py``.
"""

from __future__ import annotations

import torch

from .ops import scatter_accumulate


def row_window_scatter(values: torch.Tensor, indices: torch.Tensor, shape,
                       row0: int, rows_per: int) -> torch.Tensor:
    """Dense (rows_per, d1) sum of the pairs whose row lies in
    [row0, row0 + rows_per); every other pair, the -1 padding included
    (its row decomposes to -1), becomes -1 and is dropped."""
    d0, d1 = (int(s) for s in shape)
    rows = torch.div(indices, d1, rounding_mode="floor")     # -1 -> -1
    cols = indices - rows * d1
    local = rows - int(row0)
    in_window = (indices >= 0) & (local >= 0) & (local < rows_per)
    local_idx = torch.where(in_window, local * d1 + cols,
                            torch.full_like(indices, -1))
    return scatter_accumulate(values.contiguous(),
                              local_idx.to(torch.int32).contiguous(),
                              (int(rows_per), d1))


def mirror_expand_pairs(values: torch.Tensor, indices: torch.Tensor,
                        d1: int):
    """(n, k) lower-triangular pairs -> (n, 2k) symmetric pairs: each
    off-diagonal entry once at (r, c) and once at (c, r). Diagonal and
    padding mirrors become -1: a mirrored padding index can decompose to
    a valid cell, and a diagonal mirror would add to a cell the
    unsharded sum adds once."""
    rows = torch.div(indices, d1, rounding_mode="floor")
    cols = indices - rows * d1
    off_diag = (indices >= 0) & (rows != cols)
    mirror_idx = torch.where(off_diag, cols * d1 + rows,
                             torch.full_like(indices, -1))
    return (torch.cat([values, values], dim=-1),
            torch.cat([indices, mirror_idx], dim=-1))


def _rows_per(d0: int, world: int) -> int:
    if d0 % world:
        raise ValueError(f"sharded accumulator needs d0 % world == 0, got "
                         f"d0={d0}, world={world}")
    return d0 // world


def windowed_scatter_accumulate(values: torch.Tensor, indices: torch.Tensor,
                                shape, world: int,
                                symmetric: bool = False) -> torch.Tensor:
    """The dense (d0, d1) sum as ``world`` row windows, computed one after
    another here and stacked: what ``sharded_scatter_accumulate``
    gathers, without collectives."""
    d0, d1 = (int(s) for s in shape)
    rows_per = _rows_per(d0, world)
    if symmetric:
        values, indices = mirror_expand_pairs(values, indices, d1)
    return torch.cat([row_window_scatter(values, indices, (d0, d1),
                                         r * rows_per, rows_per)
                      for r in range(world)])


def sharded_scatter_accumulate(values: torch.Tensor, indices: torch.Tensor,
                               shape, mesh, axis: str = "data",
                               symmetric: bool = False,
                               gather: bool = False) -> torch.Tensor:
    """This rank's (d0 / W, d1) window of the dense sum of n silo
    payloads, W the extent of ``mesh[axis]`` (a ``DeviceMesh``); d0 must
    divide by W. ``gather`` all-gathers the windows to the dense
    (d0, d1) sum on every rank."""
    import torch.distributed as dist

    d0, d1 = (int(s) for s in shape)
    world = mesh.size(mesh.mesh_dim_names.index(axis))
    rows_per = _rows_per(d0, world)
    if symmetric:
        values, indices = mirror_expand_pairs(values, indices, d1)
    rank = mesh.get_local_rank(axis)
    window = row_window_scatter(values, indices, (d0, d1), rank * rows_per,
                                rows_per)
    if not gather:
        return window
    parts = [torch.empty_like(window) for _ in range(world)]
    dist.all_gather(parts, window, group=mesh.get_group(axis))
    return torch.cat(parts)
