"""Qwen2-0.5B [arXiv:2407.10671].

24 layers, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151936;
GQA with QKV bias, RoPE, SwiGLU, RMSNorm, tied embeddings; bf16 weights.
"""

from __future__ import annotations

from . import ModelConfig, model_param_shapes

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    kv_heads=2,
    d_ff=4864,
    vocab=151936,
    attn_type="gqa",
    rope=True,
    qkv_bias=True,
    mlp_type="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="[arXiv:2407.10671]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
