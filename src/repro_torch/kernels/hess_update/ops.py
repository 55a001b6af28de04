"""Fused FedNL Hessian bookkeeping (Algorithm 1, lines 5-6):
``hess_update`` returns (H + alpha * S, ||H - D||_F) from one pass.

On a CUDA tensor it launches the kernel in ``csrc/hess_update.cu``; on a
CPU tensor it runs the plain version in ``ref.py``. There is no other
path: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..tuning.cache import lookup
from .ref import hess_update_ref

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


DEFAULT_BLOCK = 128


def resolve_block(shape, dtype, device=None, block: int | None = None) -> int:
    """The tile edge ``hess_update`` uses on ``device``: ``block`` when
    given, else the tuning cache's winner for (shape, dtype, device kind),
    else 128. A cached block that is not positive, or whose launch is over
    a block's budget, gives way to 128."""
    if block is not None:
        return int(block)
    cfg = lookup("hess_update", tuple(shape), None, None, dtype, device)
    if cfg is None or cfg.block is None:
        return DEFAULT_BLOCK
    from ..resources import launch_resources, within_budget

    ok = cfg.block > 0 and within_budget(
        launch_resources("hess_update", dtype=dtype))
    return int(cfg.block) if ok else DEFAULT_BLOCK


def hess_update(h: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
                alpha: float, block: int | None = None):
    """h, d, s of one shape, (M, N) or a stack (n, M, N). Returns
    (h + alpha * s in h's type, ||h - d||_F): the norm's squares are
    summed in f32 per (block x block) tile also for f64 input, as on the
    TPU, and it is a scalar, or (n,) for a stack. Any (M, N): the ragged
    edge tiles are masked in the kernel, not padded. ``block`` None:
    ``resolve_block`` (the tuning cache, else 128)."""
    block = resolve_block(h.shape, h.dtype, h.device, block)
    if h.device.type == "cpu" and d.device.type == "cpu" \
            and s.device.type == "cpu":
        return hess_update_ref(h, d, s, alpha, block)
    if not (h.device.type == "cuda" and d.device == h.device
            and s.device == h.device):
        raise ValueError(f"hess_update: h, d and s must lie on one CUDA "
                         f"device, got {h.device}, {d.device}, {s.device}")
    if h.dtype not in _SUFFIX or d.dtype != h.dtype or s.dtype != h.dtype:
        raise TypeError(f"hess_update takes three float32 or three float64 "
                        f"tensors, got {h.dtype}, {d.dtype}, {s.dtype}")
    if h.dim() not in (2, 3) or d.shape != h.shape or s.shape != h.shape:
        raise ValueError(f"hess_update: expected three (M, N) or (n, M, N) "
                         f"tensors of one shape, got {tuple(h.shape)}, "
                         f"{tuple(d.shape)}, {tuple(s.shape)}")
    if not (h.is_contiguous() and d.is_contiguous() and s.is_contiguous()):
        raise ValueError("hess_update needs contiguous inputs")
    if block <= 0:
        raise ValueError(f"hess_update: block must be positive, got {block}")
    nmat = h.shape[0] if h.dim() == 3 else 1
    m, n = h.shape[-2:]
    out = torch.empty_like(h)
    err = torch.empty((nmat, -(-m // block) * -(-n // block)),
                      dtype=torch.float32, device=h.device)
    fn = getattr(_cuda.library("hess_update"), f"hess_update_{_SUFFIX[h.dtype]}")
    with _cuda.on(h.device):
        code = fn(h.data_ptr(), d.data_ptr(), s.data_ptr(), float(alpha),
                  out.data_ptr(), err.data_ptr(), nmat, m, n, block,
                  _cuda.stream())
    _cuda.check(code, "hess_update")
    _cuda.LAUNCHES["hess_update"] += 1
    l = torch.sqrt(torch.sum(err, dim=1))
    return out, l if h.dim() == 3 else l[0]
