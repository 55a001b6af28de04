"""Model configurations the port runs, copied from the JAX package's
``configs`` (the port imports nothing of it), each with the exact
parameter tree its model's ``init_params`` builds.

``get_config(name)`` returns the published configuration;
``get_config(name, smoke=True)`` the reduced same-family variant of the
CPU tests. ``ARCHS`` lists the reference's ten architectures, and
``model_param_shapes`` gives the parameter tree of any of them.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import torch

from ..models.config import (
    MambaConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    XLSTMConfig,
)
from ..models.transformer import layer_kinds, period_len

ARCHS = ("qwen2-0.5b", "starcoder2-3b", "starcoder2-15b", "minicpm3-4b",
         "granite-moe-1b-a400m", "grok-1-314b", "whisper-tiny",
         "llava-next-34b", "jamba-1.5-large-398b", "xlstm-350m")


class ParamShape(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def model_param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of the reference's ``init_params`` for any
    family, as ``ParamShape`` leaves, no weights made: ``layers`` holds
    one stack per position in the period (``period_len``), each over
    the n_layers / period segments on a leading axis. The mixer is GQA
    (with biases if ``qkv_bias``), MLA, Mamba (its ``dt_bias``,
    ``a_log`` and ``d_skip`` f32), mLSTM or sLSTM (its ``b`` f32); the
    feed-forward an MLP, swiglu or gelu (no ``wg``), or with ``moe`` the
    f32 ``router`` and the experts' weights on axis 1, or none (no
    ``norm2``); the norms rmsnorm or layernorm (with ``b``); ``lm_head``
    unless the embeddings are tied; for encdec each decoder layer's
    ``norm_x`` and ``cross`` attention, and the encoder's
    ``enc_layers`` and ``enc_norm_f``."""
    d, ff = cfg.d_model, cfg.d_ff
    f32 = torch.float32

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

    def mixer(n, kind: str):
        if kind == "attn":
            return gqa(n)
        if kind == "mla":
            m, h = cfg.mla, cfg.n_heads
            return {"wdq": p(n, d, m.q_lora_rank),
                    "wuq": p(n, m.q_lora_rank,
                             h * (m.qk_nope_dim + m.qk_rope_dim)),
                    "wdkv": p(n, d, m.kv_lora_rank),
                    "wkrope": p(n, d, m.qk_rope_dim),
                    "wuk": p(n, m.kv_lora_rank, h * m.qk_nope_dim),
                    "wuv": p(n, m.kv_lora_rank, h * m.v_head_dim),
                    "wo": p(n, h * m.v_head_dim, d)}
        if kind == "mamba":
            m = cfg.mamba
            di, s = m.expand * d, m.d_state
            return {"win": p(n, d, 2 * di), "conv": p(n, m.d_conv, di),
                    "conv_b": p(n, di), "wbc": p(n, di, 2 * s),
                    "wdt": p(n, di, 1), "dt_bias": p(n, di, dtype=f32),
                    "a_log": p(n, di, s, dtype=f32),
                    "d_skip": p(n, di, dtype=f32), "wout": p(n, di, d)}
        if kind == "mlstm":
            return {"wq": p(n, d, d), "wk": p(n, d, d), "wv": p(n, d, d),
                    "wif": p(n, d, 2 * cfg.n_heads), "wo_gate": p(n, d, d),
                    "wout": p(n, d, d)}
        assert kind == "slstm", kind
        return {"wx": p(n, d, 4 * d), "wr": p(n, d, 4 * d),
                "b": p(n, 4 * d, dtype=f32), "wout": p(n, d, d)}

    def layers(n, kind: tuple, cross: bool):
        mix, ffn = kind
        out = {"norm1": norm(n), "mixer": mixer(n, mix)}
        if ffn == "moe":
            e = cfg.moe.num_experts
            out.update(norm2=norm(n),
                       ffn={"router": p(n, d, e, dtype=f32), **mlp(n, e)})
        elif ffn == "mlp":
            out.update(norm2=norm(n), ffn=mlp(n))
        if cross:
            out.update(norm_x=norm(n), cross=gqa(n))
        return out

    encdec = cfg.family == "encdec"
    period = period_len(cfg)
    params = {"embed": p(cfg.vocab, d), "norm_f": norm(),
              "layers": [layers(cfg.n_layers // period, kind, encdec)
                         for kind in layer_kinds(cfg)[:period]]}
    if not cfg.tie_embeddings:
        params["lm_head"] = p(cfg.vocab, d)
    if encdec:
        params["enc_layers"] = layers(cfg.enc_layers, ("attn", "mlp"), False)
        params["enc_norm_f"] = norm()
    return params


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG.reduced() if smoke else mod.CONFIG


__all__ = ["ARCHS", "MLAConfig", "MambaConfig", "ModelConfig", "MoEConfig",
           "ParamShape", "XLSTMConfig", "get_config", "model_param_shapes"]
