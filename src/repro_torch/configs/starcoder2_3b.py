"""StarCoder2-3B [arXiv:2402.19173].

30 layers, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152;
GQA + RoPE + sliding window 4096.
"""

from __future__ import annotations

from . import ModelConfig, model_param_shapes

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    kv_heads=2,
    d_ff=12288,
    vocab=49152,
    attn_type="gqa",
    rope=True,
    sliding_window=4096,
    mlp_type="gelu",
    norm="layernorm",
    source="[arXiv:2402.19173]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
