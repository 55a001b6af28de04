"""Causal flash attention (forward), ``flash_attention``.

On CUDA tensors it launches the kernel in ``csrc/flash_attention.cu``; on
CPU tensors it runs the plain version in ``ref.py``. There is no other
path: a CUDA tensor the kernel cannot take raises. There is no backward
(the reference has none either), so an input that requires grad raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .ref import gqa_flash_attention_ref

_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
TILES = (64, 128)
HEAD_DIMS = (64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, T, H, hd) and k, v "
                         f"(B, T, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape[:2] != (b, t) or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (KV heads must divide H)")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward: call it on "
                           "tensors that do not require grad")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Causal attention over q (B, T, H, hd) and k, v (B, T, KV, hd),
    where head h reads KV head h // (H / KV). Scores, softmax statistics
    and sums in f32; the result (B, T, H, hd) in q's type. ``bq`` and
    ``bk`` are the kernel's query and key tiles (64 or 128 each); any T
    is taken, the ragged last tile masked."""
    _check(q, k, v)
    if bq not in TILES or bk not in TILES:
        raise ValueError(f"flash_attention: tiles bq={bq}, bk={bk} must be "
                         f"in {TILES}")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return gqa_flash_attention_ref(q, k, v)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k and v must lie on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, t, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = getattr(_cuda.library("flash_attention"),
                 f"flash_attention_{_TYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                 v.data_ptr(), *v.stride()[:3], out.data_ptr(), b, t, h,
                 k.shape[2], hd, bq, bk, _cuda.stream())
    _cuda.check(err, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    return out
