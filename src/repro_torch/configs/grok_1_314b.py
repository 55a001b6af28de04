"""Grok-1 (314B) [hf:xai-org/grok-1].

64 layers, d_model 6144, 48 heads (GQA kv=8), expert d_ff 32768,
vocab 131072; MoE with 8 experts, top-2.
"""

from __future__ import annotations

from . import ModelConfig, MoEConfig, model_param_shapes

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=32768,
    vocab=131072,
    attn_type="gqa",
    rope=True,
    mlp_type="gelu",
    moe=MoEConfig(num_experts=8, top_k=2),
    norm="rmsnorm",
    source="[hf:xai-org/grok-1]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
