"""Model configurations the port runs, copied from the JAX package's
``configs`` (the port imports nothing of it), each with the exact
parameter tree its model's ``init_params`` builds.

``get_config(name)`` returns the published configuration;
``get_config(name, smoke=True)`` the reduced same-family variant of the
CPU tests. ``ARCHS`` lists the architectures ported so far, and
``model_param_shapes`` gives the parameter tree of any of them.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import torch

from ..models.config import NOT_PORTED, MLAConfig, ModelConfig, MoEConfig

ARCHS = ("qwen2-0.5b", "starcoder2-3b", "starcoder2-15b", "minicpm3-4b",
         "granite-moe-1b-a400m", "grok-1-314b", "whisper-tiny",
         "llava-next-34b")
# the reference's other architectures (src/repro/configs/__init__.py)
_LATER = ("jamba-1.5-large-398b", "xlstm-350m")


class ParamShape(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def model_param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of the reference's ``init_params`` for a
    ported family, as ``ParamShape`` leaves: the layers are stacked on a
    leading axis in ``layers[0]`` (one block per period), no weights
    made. The mixer is GQA (with biases if ``qkv_bias``) or MLA; the
    feed-forward an MLP, swiglu or gelu (no ``wg``), or with ``moe`` the
    f32 ``router`` and the experts' weights on axis 1; the norms rmsnorm
    or layernorm (with ``b``); ``lm_head`` unless the embeddings are
    tied; for encdec each decoder layer's ``norm_x`` and ``cross``
    attention, and the encoder's ``enc_layers`` and ``enc_norm_f``."""
    d, ff = cfg.d_model, cfg.d_ff

    def p(*shape, dtype=cfg.tdtype):
        return ParamShape(tuple(shape), dtype)

    def norm(*lead):
        w = {"w": p(*lead, d)}
        return w if cfg.norm == "rmsnorm" else {**w, "b": p(*lead, d)}

    def gqa(n):
        q, kv = cfg.n_heads * cfg.hd, cfg.kv_heads * cfg.hd
        mixer = {"wq": p(n, d, q), "wk": p(n, d, kv), "wv": p(n, d, kv),
                 "wo": p(n, q, d)}
        if cfg.qkv_bias:
            mixer.update(bq=p(n, q), bk=p(n, kv), bv=p(n, kv))
        return mixer

    def mlp(*lead):
        ffn = {"wi": p(*lead, d, ff), "wg": p(*lead, d, ff),
               "wo": p(*lead, ff, d)}
        if cfg.mlp_type != "swiglu":
            del ffn["wg"]
        return ffn

    def layers(n, mla: bool, moe: bool, cross: bool):
        if mla:
            m, h = cfg.mla, cfg.n_heads
            mixer = {"wdq": p(n, d, m.q_lora_rank),
                     "wuq": p(n, m.q_lora_rank,
                              h * (m.qk_nope_dim + m.qk_rope_dim)),
                     "wdkv": p(n, d, m.kv_lora_rank),
                     "wkrope": p(n, d, m.qk_rope_dim),
                     "wuk": p(n, m.kv_lora_rank, h * m.qk_nope_dim),
                     "wuv": p(n, m.kv_lora_rank, h * m.v_head_dim),
                     "wo": p(n, h * m.v_head_dim, d)}
        else:
            mixer = gqa(n)
        if moe:
            e = cfg.moe.num_experts
            ffn = {"router": p(n, d, e, dtype=torch.float32), **mlp(n, e)}
        else:
            ffn = mlp(n)
        out = {"norm1": norm(n), "mixer": mixer, "norm2": norm(n), "ffn": ffn}
        if cross:
            out.update(norm_x=norm(n), cross=gqa(n))
        return out

    encdec = cfg.family == "encdec"
    params = {"embed": p(cfg.vocab, d), "norm_f": norm(),
              "layers": [layers(cfg.n_layers, cfg.attn_type == "mla",
                                cfg.moe is not None, encdec)]}
    if not cfg.tie_embeddings:
        params["lm_head"] = p(cfg.vocab, d)
    if encdec:
        params["enc_layers"] = layers(cfg.enc_layers, False, False, False)
        params["enc_norm_f"] = norm()
    return params


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in _LATER:
        raise KeyError(f"arch {name!r} is {NOT_PORTED}; ported: {ARCHS}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG.reduced() if smoke else mod.CONFIG


__all__ = ["ARCHS", "MLAConfig", "ModelConfig", "MoEConfig", "ParamShape",
           "get_config", "model_param_shapes"]
