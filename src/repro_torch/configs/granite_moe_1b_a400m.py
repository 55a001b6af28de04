"""Granite 3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model 1024, 16 heads (GQA kv=8), expert d_ff 512,
vocab 49155; MoE with 32 experts, top-8.
"""

from __future__ import annotations

from . import ModelConfig, MoEConfig, model_param_shapes

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=8,
    d_ff=512,
    vocab=49155,
    attn_type="gqa",
    rope=True,
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=32, top_k=8),
    norm="rmsnorm",
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
