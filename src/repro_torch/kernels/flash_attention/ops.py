"""Causal flash attention (forward), ``flash_attention``, optionally over
a sliding window (starcoder2's 4,096 keys).

On CUDA tensors it launches a kernel chosen by the inputs' type, never by
what is available: bf16 takes the tensor-core kernel in
``csrc/flash_attention_wgmma.cu`` (wgmma fed by TMA; P rounded to bf16
before P V, as on every tensor-core flash attention), f32 the FFMA kernel
in ``csrc/flash_attention.cu`` (f32 products and sums, no TF32). On CPU
tensors it runs the plain version in ``ref.py``. There is no other path:
a CUDA tensor the chosen kernel cannot take raises, and so does a failed
build or launch. There is no backward (the reference has none either), so
an input that requires grad raises.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..tuning.cache import lookup
from .ref import gqa_flash_attention_ref

# the kernel route of each input type: (route, library, entry point)
_BY_DTYPE = {
    torch.bfloat16: ("wgmma", "flash_attention_wgmma", "flash_attention_bf16"),
    torch.float32: ("ffma", "flash_attention", "flash_attention_f32")}
TILES = (64, 128)
# bq = bk = 128 serves both head dims: at hd 128 the wgmma kernel holds
# 64 f32 output and 64 score accumulators per thread in 165 registers, no
# spill (ptxas on sm_90a, printed by chip_smoke.py's build), and two K/V
# stages fit its shared memory
HEAD_DIMS = (64, 128)
# TMA reads the bf16 inputs: their address and strides must be multiples
# of 16 bytes
TMA_ALIGN_BYTES = 16


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


def route(dtype: torch.dtype) -> str:
    """The kernel route that serves ``dtype`` on a card: "wgmma" for bf16,
    "ffma" for f32; any other type raises."""
    if dtype not in _BY_DTYPE:
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v, got "
                        f"{dtype}")
    return _BY_DTYPE[dtype][0]


def tma_strides(shape, strides, data_ptr: int) -> tuple[int, int, int]:
    """The batch, sequence and head strides (elements) under which TMA
    reads a bf16 (B, T, N, hd) input: a dimension of size 1 takes its
    contiguous stride (its own is never used). Raises unless the address
    and every such stride are multiples of 16 bytes."""
    dense = (shape[1] * shape[2] * shape[3], shape[2] * shape[3], shape[3])
    out = tuple(dense[i] if shape[i] == 1 else strides[i] for i in range(3))
    if data_ptr % TMA_ALIGN_BYTES or any(
            (2 * s) % TMA_ALIGN_BYTES for s in out):
        raise ValueError(
            f"flash_attention: bf16 inputs are read by TMA, which needs "
            f"16-byte multiples: address {data_ptr:#x}, strides "
            f"{tuple(strides[:3])} (elements); pass a contiguous tensor")
    return out


DEFAULT_TILES = (128, 128)


def resolve_tiles(t: int, hd: int, n_rep: int, window: int | None, dtype,
                  device=None, bq: int | None = None,
                  bk: int | None = None) -> tuple[int, int]:
    """(bq, bk) of the launch on ``device``: the tiles given (128 for one
    left None), else the tuning cache's winner for (T, hd), n_rep, the
    window and the type, else (128, 128). A cached pair outside ``TILES``
    or over a block's budget gives way to (128, 128)."""
    if bq is not None or bk is not None:
        return (DEFAULT_TILES[0] if bq is None else int(bq),
                DEFAULT_TILES[1] if bk is None else int(bk))
    cfg = lookup("flash_attention", (t, hd), n_rep, window, dtype, device)
    if cfg is None or cfg.bq not in TILES or cfg.bk not in TILES:
        return DEFAULT_TILES
    from ..resources import launch_resources, within_budget

    if hd in HEAD_DIMS and not within_budget(launch_resources(
            "flash_attention", dtype=dtype, hd=hd, bq=cfg.bq, bk=cfg.bk)):
        return DEFAULT_TILES
    return cfg.bq, cfg.bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int | None = None, bk: int | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Causal attention over q (B, T, H, hd) and k, v (B, T, KV, hd),
    where head h reads KV head h // (H / KV); with a sliding ``window``
    query i attends to keys j with i - window < j <= i, and the kernel
    walks only the key tiles the window reaches. Scores, softmax
    statistics and sums in f32; the result (B, T, H, hd) in q's type.
    ``bq`` and ``bk`` are the kernel's query and key tiles (64 or 128
    each; None: ``resolve_tiles``, the tuning cache, else 128); any T is
    taken, the ragged last tile masked. On a card, bf16
    runs on the tensor cores with P rounded to bf16 before P V, f32 on
    the CUDA cores (``route``)."""
    _check(q, k, v)
    if (bq is not None and bq not in TILES) or (
            bk is not None and bk not in TILES):
        raise ValueError(f"flash_attention: tiles bq={bq}, bk={bk} must be "
                         f"in {TILES}")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"flash_attention: window must be None or an int "
                         f">= 1, got {window!r}")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return gqa_flash_attention_ref(q, k, v, window)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k and v must lie on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    kind = route(q.dtype)
    b, t, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    bq, bk = resolve_tiles(t, hd, h // k.shape[2], window, q.dtype, q.device,
                           bq, bk)
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    if kind == "wgmma":
        strides = [tma_strides(x.shape, x.stride(), x.data_ptr())
                   for x in (q, k, v)]
    else:
        strides = [x.stride()[:3] for x in (q, k, v)]
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _, lib, entry = _BY_DTYPE[q.dtype]
    fn = getattr(_cuda.library(lib), entry)
    with _cuda.on(q.device):
        err = fn(q.data_ptr(), *strides[0], k.data_ptr(), *strides[1],
                 v.data_ptr(), *strides[2], out.data_ptr(), b, t, h,
                 k.shape[2], hd, bq, bk, window or 0, _cuda.stream())
    _cuda.check(err, f"flash_attention ({kind})")
    _cuda.count("flash_attention", kind)
    return out
