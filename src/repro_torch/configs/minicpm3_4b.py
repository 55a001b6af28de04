"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B].

62 layers, d_model 2560, 40 heads, d_ff 6400, vocab 73448; MLA attention
(q_lora 768, kv_lora 256, rope dim 32, nope dim 64, v dim 64 per the
model card) — the latent KV cache is the arch's distinguishing feature.
"""

from __future__ import annotations

from . import MLAConfig, ModelConfig, model_param_shapes

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    rope=True,
    mlp_type="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="[hf:openbmb/MiniCPM3-4B]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
