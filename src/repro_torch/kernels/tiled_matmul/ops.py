"""f32-accumulated matrix product ``tiled_matmul`` and the PowerSGD
rank-R compression ``powersgd_rank_r`` that runs on it.

On CUDA tensors ``tiled_matmul`` launches the kernel in
``csrc/tiled_matmul.cu``; on CPU tensors it runs the plain version in
``ref.py``. There is no other path: a CUDA tensor the kernel cannot take
raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .ref import tiled_matmul_ref


def _strided(x: torch.Tensor) -> torch.Tensor:
    """x as is when one of its strides is 1 (row- or column-major, a
    transposed view included), else a contiguous copy."""
    return x if 1 in x.stride() else x.contiguous()


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) from f32 operands with f32 accumulation (no
    TF32), returned in a's type — an f64 call computes in f32, as on the
    TPU. Transposed views are read in place."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: cannot multiply {tuple(a.shape)} "
                         f"by {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tiled_matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tiled_matmul: a and b must lie on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if not (a.is_floating_point() and b.is_floating_point()):
        raise TypeError(f"tiled_matmul takes floating tensors, got {a.dtype} "
                        f"and {b.dtype}")
    a32 = _strided(a.to(torch.float32))
    b32 = _strided(b.to(torch.float32))
    m, k = a32.shape
    n = b32.shape[1]
    if -(-m // 64) > 65535:
        raise ValueError(f"tiled_matmul: {m} rows exceed the kernel's grid")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = _cuda.library("tiled_matmul").tiled_matmul_f32
    with torch.cuda.device(a.device):
        err = fn(a32.data_ptr(), a32.stride(0), a32.stride(1), b32.data_ptr(),
                 b32.stride(0), b32.stride(1), c.data_ptr(), m, n, k,
                 _cuda.stream())
    _cuda.check(err, "tiled_matmul")
    _cuda.LAUNCHES["tiled_matmul"] += 1
    return c.to(a.dtype)


def subspace_iteration(m: torch.Tensor, q: torch.Tensor,
                       iters: int = 2) -> torch.Tensor:
    """Rank-r approximation of m (d0, d1) by ``iters`` rounds of subspace
    iteration from the orthonormal start ``q`` (d1, r): every product
    through ``tiled_matmul``, QR through ``torch.linalg.qr`` (O(d r^2),
    not the hot loop). Returned in m's type."""
    m32 = m.to(torch.float32)
    q = q.to(torch.float32)
    for _ in range(iters):
        p, _ = torch.linalg.qr(tiled_matmul(m32, q))
        q, _ = torch.linalg.qr(tiled_matmul(m32.T, p))
    p = tiled_matmul(m32, q)
    return tiled_matmul(p, q.T).to(m.dtype)


def powersgd_rank_r(m: torch.Tensor, r: int, iters: int = 2,
                    seed: int = 0) -> torch.Tensor:
    """Rank-r compression of m by subspace iteration from a Gaussian
    start drawn from a ``torch.Generator`` seeded with ``seed`` (not the
    reference's ``jax.random`` draw: pass that to ``subspace_iteration``
    to reproduce it)."""
    gen = torch.Generator(device=m.device).manual_seed(seed)
    q = torch.randn((m.shape[1], r), generator=gen, dtype=torch.float32,
                    device=m.device)
    q, _ = torch.linalg.qr(q)
    return subspace_iteration(m, q, iters)
