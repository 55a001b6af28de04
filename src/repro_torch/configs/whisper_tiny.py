"""Whisper tiny [arXiv:2212.04356].

4 encoder + 4 decoder layers, d_model 384, 6 heads, d_ff 1536,
vocab 51865. The mel+conv audio frontend is a stub, as in the
reference: the inputs hold (B, 1500, 384) frame embeddings. Sinusoidal
positions (any length), full attention.
"""

from __future__ import annotations

from . import ModelConfig, model_param_shapes

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    kv_heads=6,
    d_ff=1536,
    vocab=51865,
    attn_type="gqa",
    rope=False,                    # sinusoidal positions instead
    mlp_type="gelu",
    norm="layernorm",
    source="[arXiv:2212.04356]",
)


def param_shapes(cfg: ModelConfig = CONFIG) -> dict:
    """The parameter tree of the reference's ``init_params`` for this
    model, as ``ParamShape`` leaves (``model_param_shapes``)."""
    return model_param_shapes(cfg)
