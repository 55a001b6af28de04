"""Jamba 1.5 Large (398B total, ~94B active) [arXiv:2403.19887, 2408.12570].

72 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536;
Mamba : attention = 7 : 1 interleave (one attention layer per period of
8, no positional encoding in it); MoE with 16 experts, top-2, on every
other layer.
"""

from __future__ import annotations

from . import MambaConfig, ModelConfig, MoEConfig, model_param_shapes

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=24576,
    vocab=65536,
    attn_type="gqa",
    rope=False,                    # jamba's attention has no positions
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2),
    moe_every=2,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    norm="rmsnorm",
    source="[arXiv:2403.19887]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``): one stack
    per position of the 8-layer period."""
    return model_param_shapes(cfg)
