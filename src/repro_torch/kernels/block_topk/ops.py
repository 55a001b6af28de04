"""Fused FedNL uplink for Block-Top-K: ``diff_topk_payload``.

On a CUDA tensor it launches the kernel in ``csrc/block_topk.cu``; on a
CPU tensor it runs the plain version in ``ref.py``. There is no other
path: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .ref import diff_topk_payload_ref

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def diff_topk_payload(a: torch.Tensor, b: torch.Tensor, k: int,
                      block: int = 128):
    """Block-Top-K payload of D_i = a_i - b_i for stacked a, b (n, M, N).

    Returns (values, indices, sumsq): values and in-tile flat indices
    are (n, tiles, min(k, block^2)) with tiles in row-major grid order
    and -1 in empty slots; sumsq (n,) is ||D_i||_F^2. The dense
    difference is never written to device memory on the kernel path."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    k = min(int(k), block * block)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return diff_topk_payload_ref(a, b, k, block)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"a and b must lie on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if dt not in _SUFFIX:
        raise TypeError(f"diff_topk_payload takes float32/float64, got {dt}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected two (n, M, N) tensors of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("diff_topk_payload needs contiguous inputs")
    if block > 128:
        raise ValueError(f"the CUDA kernel takes block <= 128, got {block}")
    n, m, nn = a.shape
    nblk = -(-m // block) * -(-nn // block)
    vals = torch.empty((n, nblk, k), dtype=dt, device=a.device)
    idx = torch.empty((n, nblk, k), dtype=torch.int32, device=a.device)
    sq = torch.empty((n, nblk), dtype=dt, device=a.device)
    fn = getattr(_cuda.library("block_topk"), f"diff_topk_payload_{_SUFFIX[dt]}")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 sq.data_ptr(), n, m, nn, block, k, _cuda.stream())
    _cuda.check(err, "diff_topk_payload")
    _cuda.LAUNCHES["diff_topk_payload"] += 1
    return vals, idx, torch.sum(sq, dim=1)
