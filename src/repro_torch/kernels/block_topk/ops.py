"""Block-local Top-K per (block x block) tile: the fused FedNL uplink
``diff_topk_payload``, the payload of x itself ``block_topk_payload``,
and the dense masked tile ``block_topk``.

On a CUDA tensor each launches its kernel in ``csrc/block_topk.cu``; on
a CPU tensor it runs the plain version in ``ref.py``. There is no other
path: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .ref import block_topk_payload_ref, block_topk_ref, diff_topk_payload_ref

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name: str, x: torch.Tensor, block: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32/float64, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (n, M, N), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs contiguous inputs")
    if not 0 < block <= 128:
        raise ValueError(f"{name}: the CUDA kernel takes 0 < block <= 128, "
                         f"got {block}")


def _grid(m: int, n: int, block: int) -> int:
    return -(-m // block) * -(-n // block)


def diff_topk_payload(a: torch.Tensor, b: torch.Tensor, k: int,
                      block: int = 128):
    """Block-Top-K payload of D_i = a_i - b_i for stacked a (n, M, N) and
    b (n, M, N), or one b (M, N) shared by every silo (read in place,
    never copied n times).

    Returns (values, indices, sumsq): values and in-tile flat indices
    are (n, tiles, min(k, block^2)) with tiles in row-major grid order
    and -1 in empty slots; sumsq (n,) is ||D_i||_F^2. The dense
    difference is never written to device memory on the kernel path."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    k = min(int(k), block * block)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return diff_topk_payload_ref(a, b, k, block)
    if a.device != b.device:
        raise ValueError(f"a and b must lie on one CUDA device, got "
                         f"{a.device} and {b.device}")
    _check("diff_topk_payload", a, block)
    shared = b.dim() == 2
    if b.shape != (a.shape[1:] if shared else a.shape):
        raise ValueError(f"expected b of shape {tuple(a.shape)} or "
                         f"{tuple(a.shape[1:])}, got {tuple(b.shape)}")
    if not b.is_contiguous():
        raise ValueError("diff_topk_payload needs contiguous inputs")
    n, m, nn = a.shape
    nblk = _grid(m, nn, block)
    vals = torch.empty((n, nblk, k), dtype=dt, device=a.device)
    idx = torch.empty((n, nblk, k), dtype=torch.int32, device=a.device)
    sq = torch.empty((n, nblk), dtype=dt, device=a.device)
    fn = getattr(_cuda.library("block_topk"), f"diff_topk_payload_{_SUFFIX[dt]}")
    with _cuda.on(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), 0 if shared else m * nn,
                 vals.data_ptr(), idx.data_ptr(), sq.data_ptr(), n, m, nn,
                 block, k, _cuda.stream())
    _cuda.check(err, "diff_topk_payload")
    _cuda.LAUNCHES["diff_topk_payload"] += 1
    return vals, idx, torch.sum(sq, dim=1)


def block_topk_payload(x: torch.Tensor, k: int, block: int = 128,
                       bisect_all: bool = False):
    """Block-Top-K payload of x (M, N), or of each matrix of a stack
    (n, M, N): (values, in-tile flat indices), both (tiles, min(k,
    block^2)) per matrix, tiles in row-major grid order, exactly k
    entries per tile (strict survivors, then bracket ties in flat order),
    -1 in empty slots. With k >= block^2 the whole tile is kept in flat
    order; ``bisect_all`` orders it by the bracket all the same (the
    order of ``BlockTopKThreshold.compress``)."""
    k = min(int(k), block * block)
    stacked = x.dim() == 3
    x3 = x if stacked else x.unsqueeze(0)
    if x.device.type == "cpu":
        vals, idx = block_topk_payload_ref(x3, k, block, bisect_all)
    else:
        _check("block_topk_payload", x3, block)
        n, m, nn = x3.shape
        nblk = _grid(m, nn, block)
        vals = torch.empty((n, nblk, k), dtype=x.dtype, device=x.device)
        idx = torch.empty((n, nblk, k), dtype=torch.int32, device=x.device)
        fn = getattr(_cuda.library("block_topk"),
                     f"block_topk_payload_{_SUFFIX[x.dtype]}")
        with _cuda.on(x.device):
            err = fn(x3.data_ptr(), vals.data_ptr(), idx.data_ptr(), n, m, nn,
                     block, k, int(bool(bisect_all)), _cuda.stream())
        _cuda.check(err, "block_topk_payload")
        _cuda.LAUNCHES["block_topk_payload"] += 1
    return (vals, idx) if stacked else (vals[0], idx[0])


def block_topk(x: torch.Tensor, k: int, block: int = 128) -> torch.Tensor:
    """Dense block top-k of x (M, N) or of each matrix of (n, M, N): per
    tile, x where |x| >= the upper end of the f32 bisection bracket of
    the k-th magnitude, else 0 — so fewer than k entries survive inside a
    tie cluster; x itself when k >= block^2."""
    stacked = x.dim() == 3
    x3 = x if stacked else x.unsqueeze(0)
    if x.device.type == "cpu":
        out = block_topk_ref(x3, k, block)
    else:
        _check("block_topk", x3, block)
        n, m, nn = x3.shape
        out = torch.empty_like(x3)
        fn = getattr(_cuda.library("block_topk"), f"block_topk_{_SUFFIX[x.dtype]}")
        with _cuda.on(x.device):
            err = fn(x3.data_ptr(), out.data_ptr(), n, m, nn, block,
                     min(int(k), block * block), _cuda.stream())
        _cuda.check(err, "block_topk")
        _cuda.LAUNCHES["block_topk"] += 1
    return out if stacked else out[0]
