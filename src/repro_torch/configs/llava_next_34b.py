"""LLaVA-NeXT 34B backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf, 34B variant].

60 layers, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000.
The vision tower and projector are stubs, as in the reference: the
inputs hold precomputed patch embeddings. anyres tiling is represented
by the patch count (base 576 + 4 tiles x 576 = 2880).
"""

from __future__ import annotations

from . import ModelConfig, model_param_shapes

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    kv_heads=8,
    d_ff=20480,
    vocab=64000,
    attn_type="gqa",
    rope=True,
    mlp_type="swiglu",
    vision_tokens=2880,            # anyres: 576 base + 4 x 576 tiles
    norm="rmsnorm",
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
