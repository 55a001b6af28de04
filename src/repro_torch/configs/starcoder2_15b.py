"""StarCoder2-15B [arXiv:2402.19173].

40 layers, d_model 6144, 48 heads (GQA kv=4), d_ff 24576, vocab 49152;
GQA + RoPE, sliding-window attention (4096) — which is what lets the
long_500k decode shape run with a windowed cache.
"""

from __future__ import annotations

from . import ModelConfig, model_param_shapes

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    kv_heads=4,
    d_ff=24576,
    vocab=49152,
    attn_type="gqa",
    rope=True,
    sliding_window=4096,
    mlp_type="gelu",               # StarCoder2 uses a plain GELU MLP (4x)
    norm="layernorm",
    source="[arXiv:2402.19173]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
