"""Qwen2-0.5B [arXiv:2407.10671].

24 layers, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151936;
GQA with QKV bias, RoPE, SwiGLU, RMSNorm, tied embeddings; bf16 weights.
"""

from __future__ import annotations

from . import ModelConfig, ParamShape

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
    dense decoder, as ``ParamShape`` leaves: the layers are stacked on a
    leading axis in ``layers[0]`` (one block per period), no weights made."""
    n, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.kv_heads * cfg.hd

    def p(*shape):
        return ParamShape(tuple(shape), cfg.tdtype)

    mixer = {"wq": p(n, d, q), "wk": p(n, d, kv), "wv": p(n, d, kv),
             "wo": p(n, q, d)}
    if cfg.qkv_bias:
        mixer.update(bq=p(n, q), bk=p(n, kv), bv=p(n, kv))
    params = {
        "embed": p(cfg.vocab, d),
        "norm_f": {"w": p(d)},
        "layers": [{
            "norm1": {"w": p(n, d)},
            "mixer": mixer,
            "norm2": {"w": p(n, d)},
            "ffn": {"wi": p(n, d, ff), "wg": p(n, d, ff), "wo": p(n, ff, d)},
        }],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = p(cfg.vocab, d)
    return params
