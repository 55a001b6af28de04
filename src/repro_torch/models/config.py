"""Architecture configuration: the port's copy of the reference's
``ModelConfig`` (``src/repro/models/config.py``), with the fields of the
dense decoder family. The other families (MoE, MLA, Mamba, xLSTM,
encoder-decoder, VLM) and their fields wait for ROADMAP Queue A item 12.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NOT_PORTED = "not ported yet (ROADMAP Queue A item 12)"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention
    attn_type: str = "gqa"
    rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False         # qwen2
    sliding_window: Optional[int] = None
    # mlp
    mlp_type: str = "swiglu"       # swiglu | gelu
    # norm & misc
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # citation (source of the numbers)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def supports_long_decode(self) -> bool:
        """True if a 524k-token decode state is sub-quadratic or windowed
        (the dense family: only with a sliding window)."""
        return self.sliding_window is not None

    def reduced(self, n_layers: int = 2, d_model: int = 256, d_ff: int = 512,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family, as the reference's."""
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(heads, self.kv_heads if self.kv_heads < self.n_heads
                        else heads))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=heads,
            kv_heads=kv,
            d_ff=d_ff,
            vocab=vocab,
            head_dim=d_model // heads,
            sliding_window=16 if self.sliding_window else None,
            dtype="float32",
        )


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port cannot run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: {NOT_PORTED}")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.attn_type} attention: {NOT_PORTED}")
    if cfg.sliding_window is not None:
        raise NotImplementedError(f"sliding-window attention: {NOT_PORTED}")
