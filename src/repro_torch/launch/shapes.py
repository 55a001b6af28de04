"""The assigned input shapes and their stand-ins, counterpart of
``src/repro/launch/shapes.py``:

  train_4k       seq 4096,    global_batch 256   (train step)
  prefill_32k    seq 32768,   global_batch 32    (prefill forward)
  decode_32k     seq 32768,   global_batch 128   (serve step, 1 token)
  long_500k      seq 524288,  global_batch 1     (serve step, 1 token)

The stand-ins are tensors on the ``meta`` device, the port's
counterpart of ``jax.ShapeDtypeStruct``: shape and dtype, no storage.
The port runs the dense family, so batches hold tokens and targets only
(the VLM and encoder-decoder inputs wait for ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype``: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Stand-ins of a train or prefill batch."""
    b, t = shape.global_batch, shape.seq_len
    return {"tokens": sds((b, t), torch.int32),
            "targets": sds((b, t), torch.int32)}


def decode_input_specs(cfg: ModelConfig, shape: InputShape, model) -> dict:
    """Stand-ins of a serve step's inputs: a cache of ``seq_len`` and one
    token."""
    b, t = shape.global_batch, shape.seq_len
    return {"cache": model.init_cache(b, t, device="meta"),
            "token": sds((b, 1), torch.int32),
            "pos": sds((), torch.int32)}


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """Why an (arch, shape) pair is skipped, or None if it runs."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        if cfg.family == "encdec":
            return ("whisper decoder max context is 448 by construction; a "
                    "524k full-attention self-attn cache is architecturally "
                    "meaningless (DESIGN.md §4)")
        return ("pure full-attention stack without sliding-window/block-"
                "sparse variant; long_500k requires sub-quadratic attention "
                "(DESIGN.md §4)")
    return None
