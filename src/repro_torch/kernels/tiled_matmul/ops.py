"""f32-accumulated matrix product ``tiled_matmul`` and the PowerSGD
rank-R compression ``powersgd_rank_r`` that runs on it.

On CUDA tensors ``tiled_matmul`` launches one of three kernels in
``csrc/tiled_matmul.cu``, chosen by ``plan`` from the shapes and strides:
"small_n" (N <= 8: M @ Q and M^T @ P of the power iteration), "small_k"
(K <= 8: P @ Q^T) or "tiled" (any other shape, and the skinny ones whose
strides or extents do not allow 16-byte access). On CPU tensors it runs
the plain version in ``ref.py``. There is no other path: a CUDA tensor
the kernels cannot take raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _cuda
from ..tuning.cache import lookup
from .ref import tiled_matmul_ref


def _strided(x: torch.Tensor) -> torch.Tensor:
    """x in f32 (as is when it is f32 already), read in place when one of
    its strides is 1 (row- or column-major, a transposed view included),
    else a contiguous copy."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x if 1 in x.stride() else x.contiguous()


SKINNY = 8            # the largest N of "small_n" and K of "small_k"
TARGET_BLOCKS = 528   # 4 blocks on each of the H100's 132 SMs
MIN_CHUNK = {"rows": 512, "cols": 64}  # least K per block of "small_n"


class Plan(NamedTuple):
    route: str          # "small_n", "small_k" or "tiled"
    chunks: int = 1     # "small_n": K cut into chunks of kc, summed after
    kc: int = 0


def plan(m: int, n: int, k: int, a_strides: tuple[int, int],
         a_aligned: bool) -> Plan:
    """The kernel route for A (m, k) with element strides ``a_strides``
    times B (k, n); ``a_aligned`` says A's address is a multiple of 16
    bytes. "small_n" reads A 16 bytes a load: row-major (stride 1 along
    K, one block per row) with its row stride and K multiples of 4, or
    column-major (stride 1 along M, 128 rows a block) with its column
    stride and M multiples of 4; K is cut into chunks where the blocks
    would not fill the card. "small_k" writes C 16 bytes a store, so N
    is a multiple of 4. Every other shape is tiled."""
    sam, sak = a_strides
    if n <= SKINNY and a_aligned:
        if sak == 1 and sam % 4 == 0 and k % 4 == 0:   # rows
            blocks, least = m, MIN_CHUNK["rows"]
        elif sam == 1 and sak % 4 == 0 and m % 4 == 0:  # cols
            blocks, least = -(-m // 128), MIN_CHUNK["cols"]
        else:
            blocks = 0
        if blocks:
            chunks = min(-(-TARGET_BLOCKS // blocks), -(-k // least))
            kc = max(4, -(-k // max(chunks, 1)))
            if sak == 1:
                kc = -(-kc // 4) * 4
            return Plan("small_n", max(1, -(-k // kc)), kc)
    if k <= SKINNY and n % 4 == 0:
        return Plan("small_k")
    return Plan("tiled")


def with_chunks(p: Plan, k: int, chunks: int, rows: bool) -> Plan:
    """A "small_n" plan with K cut into about ``chunks`` chunks (a
    multiple of 4 entries each for row-major A): the chunk count it
    gives and its chunk length."""
    kc = max(4, -(-k // max(int(chunks), 1)))
    if rows:
        kc = -(-kc // 4) * 4
    return Plan(p.route, max(1, -(-k // kc)), kc)


def resolve_plan(m: int, n: int, k: int, a_strides: tuple[int, int],
                 a_aligned: bool, device=None,
                 chunks: int | None = None) -> Plan:
    """``plan``'s route; on the small_n route the K chunk count given,
    else the tuning cache's winner for (A's (M, K), N, device kind), else
    ``plan``'s. A cached count outside [1, 65535] gives way to
    ``plan``'s."""
    p = plan(m, n, k, a_strides, a_aligned)
    if p.route != "small_n":
        return p
    rows = a_strides[1] == 1
    if chunks is not None:
        if not 1 <= int(chunks) <= 65535:
            raise ValueError(f"tiled_matmul: chunks {chunks} outside "
                             f"[1, 65535]")
        return with_chunks(p, k, chunks, rows)
    cfg = lookup("tiled_matmul", (m, k), None, n, torch.float32, device)
    if cfg is None or cfg.chunks is None or not 1 <= cfg.chunks <= 65535:
        return p
    return with_chunks(p, k, cfg.chunks, rows)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor,
                 chunks: int | None = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) from f32 operands with f32 accumulation (no
    TF32), returned in a's type — an f64 call computes in f32, as on the
    TPU. Transposed views are read in place. ``chunks`` sets the K chunks
    of the small_n route (``resolve_plan``: else the tuning cache, else
    ``plan``); the other routes have none."""
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
    a32, b32 = _strided(a), _strided(b)
    m, k = a32.shape
    n = b32.shape[1]
    p = resolve_plan(m, n, k, a32.stride(), a32.data_ptr() % 16 == 0,
                     a.device, chunks)
    rows_per_block = {"tiled": 64, "small_k": 8}.get(p.route, 1)
    if p.route != "small_n" and -(-m // rows_per_block) > 65535:
        raise ValueError(f"tiled_matmul: {m} rows exceed the kernel's grid")
    c = a32.new_empty((m, n))
    lib = _cuda.library("tiled_matmul")
    args = (a32.data_ptr(), *a32.stride(), b32.data_ptr(), *b32.stride(),
            c.data_ptr())
    with _cuda.on(a.device):
        if p.route == "small_n":
            part = a32.new_empty((p.chunks, m, n)) if p.chunks > 1 else None
            err = lib.tiled_matmul_small_n_f32(
                *args, None if part is None else part.data_ptr(), m, n, k,
                p.chunks, p.kc, _cuda.stream())
        elif p.route == "small_k":
            err = lib.tiled_matmul_small_k_f32(*args, m, n, k, _cuda.stream())
        else:
            err = lib.tiled_matmul_f32(*args, m, n, k, _cuda.stream())
    _cuda.check(err, f"tiled_matmul ({p.route})")
    _cuda.count("tiled_matmul", p.route)
    return c if a.dtype == torch.float32 else c.to(a.dtype)


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
