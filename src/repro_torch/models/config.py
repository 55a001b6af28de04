"""Architecture configuration: the port's copy of the reference's
``ModelConfig``, ``MLAConfig``, ``MoEConfig``, ``MambaConfig`` and
``XLSTMConfig`` (``src/repro/models/config.py``), for all six of its
families: dense (GQA with an optional sliding window, or MLA), moe (an
MoE feed-forward in every layer), hybrid (jamba: periods of Mamba layers
and one attention layer, MoE on the odd layers), ssm (xLSTM: periods of
mLSTM blocks and one sLSTM), encdec (whisper: an encoder stack over
stubbed frame embeddings and a decoder with cross-attention) and vlm
(llava: patch embeddings before the tokens).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NOT_PORTED = "not a configuration of the reference's model zoo"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    group_size: int = 512          # routing group for the dispatch
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8           # one sLSTM per this many blocks (7:1)
    chunk: int = 256               # chunkwise-parallel mLSTM chunk length
    proj_factor: float = 2.0       # ffn expansion inside blocks


PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention
    attn_type: str = "gqa"         # gqa | mla
    rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False         # qwen2
    sliding_window: Optional[int] = None  # starcoder2: 4096
    mla: Optional[MLAConfig] = None
    # mlp
    mlp_type: str = "swiglu"       # swiglu | gelu
    # moe
    moe: Optional[MoEConfig] = None
    moe_every: int = 1             # MoE layer period (jamba: 2)
    # hybrid / ssm
    mamba: Optional[MambaConfig] = None
    attn_every: int = 8            # jamba: 1 attention per 8 layers
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500            # audio frames after the conv stub
    # vlm (llava)
    vision_tokens: int = 0         # prepended patch embeddings
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
        """True if a 524k-token decode state is sub-quadratic or windowed:
        the recurrent families, or a sliding window."""
        if self.family in ("hybrid", "ssm"):
            return True
        return self.sliding_window is not None

    def reduced(self, n_layers: int = 2, d_model: int = 256, d_ff: int = 512,
                vocab: int = 512, experts: int = 4) -> "ModelConfig":
        """Smoke-test variant of the same family, as the reference's."""
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(heads, self.kv_heads if self.kv_heads < self.n_heads
                        else heads))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(experts, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), group_size=64)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                            qk_rope_dim=16, v_head_dim=32)
        xl = None
        if self.xlstm is not None:
            xl = dataclasses.replace(self.xlstm, slstm_every=2, chunk=32)
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
            moe=moe,
            mla=mla,
            xlstm=xl,
            attn_every=2 if self.family == "hybrid" else self.attn_every,
            enc_layers=min(2, self.enc_layers) if self.enc_layers else 0,
            enc_seq=32 if self.enc_layers else self.enc_seq,
            vision_tokens=16 if self.vision_tokens else 0,
            sliding_window=16 if self.sliding_window else None,
            dtype="float32",
        )


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the reference's: a family or an
    attention type it does not have."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: {NOT_PORTED}")
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.attn_type} attention: {NOT_PORTED}")
