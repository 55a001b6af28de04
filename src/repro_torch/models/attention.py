"""Attention: GQA (RoPE, QKV bias, sliding window) and MLA (MiniCPM3's
multi-head latent attention with decoupled RoPE), with the prefill
forward and single-token decode against a KV cache, and the
encoder-decoder's two full (non-causal) attentions, whisper's encoder
self-attention and the decoder's cross-attention over the encoder's
memory, the counterparts of ``src/repro/models/attention.py``.

Cache layouts:
  GQA: {"k": (B, S, KV, hd), "v": (B, S, KV, hd)}
  MLA: {"ckv": (B, S, kv_lora), "krope": (B, S, rope_dim)}, the latent
       cache.
Decode writes the new token's entries into the cache in place (the
reference returns an updated copy): a step then moves one token's keys,
not the cache.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from .common import (apply_rope, causal_mask, decode_mask, dense_init,
                     shard_act)
from .config import ModelConfig, require_ported

# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    dt = cfg.tdtype
    p = {
        "wq": dense_init(gen, d, h * hd, dt),
        "wk": dense_init(gen, d, kv * hd, dt),
        "wv": dense_init(gen, d, kv * hd, dt),
        "wo": dense_init(gen, h * hd, d, dt,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, t, h, hd), k.reshape(b, t, kv, hd),
            v.reshape(b, t, kv, hd))


def _sdpa(q, k, v, mask, n_rep: int):
    """q: (B,T,H,hd); k/v: (B,S,KV,hd); mask: (T,S) or (B,T,S) bool."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, n_rep, hd)
    scores = torch.einsum("btkrh,bskh->bkrts", qg, k).float()
    scores = scores / math.sqrt(hd)
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrts,bskh->btkrh", w, v)
    return out.reshape(b, t, h, hd)


# Query-chunk size of the long-sequence branch (T > 2 * SDPA_CHUNK), as
# in the reference.
SDPA_CHUNK = 256


def _sdpa_chunked(q, k, v, n_rep: int, window=None, chunk: int = SDPA_CHUNK):
    """Causal attention over query chunks, the reference's differentiable
    long-sequence attention. q: (B,T,H,hd) with query i at absolute
    position i; k/v: (B,T,KV,hd). T is padded up to a multiple of
    ``chunk``; each chunk attends to every key j <= its query's position
    (and, with a sliding window, j > position - window) and is recomputed
    in the backward (``checkpoint``, the counterpart of
    ``jax.checkpoint``), so the per-chunk softmax weights are not kept."""
    b, t, h, hd = q.shape
    pad = (-t) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    j = torch.arange(t, device=q.device)

    def one_chunk(qi, start: int):
        qpos = start + torch.arange(chunk, device=q.device)
        mask = j[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (j[None, :] > qpos[:, None] - window)
        return _sdpa(qi, k, v, mask, n_rep)

    out = [checkpoint(one_chunk, qi, start, use_reentrant=False)
           for qi, start in zip(q.split(chunk, dim=1),
                                range(0, q.shape[1], chunk))]
    return torch.cat(out, dim=1)[:, :t]


def gqa_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Above 2 * SDPA_CHUNK tokens the reference runs ``_sdpa_chunked``;
    so does the port while autograd records (K9 has no backward), and
    every other call runs the flash-attention kernel (K9). Each branch
    takes the config's sliding window."""
    require_ported(cfg)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = (shard_act(a, "bthd") for a in (q, k, v))
    n_rep, window = cfg.n_heads // cfg.kv_heads, cfg.sliding_window
    if t <= 2 * SDPA_CHUNK:
        out = _sdpa(q, k, v, causal_mask(t, window, device=x.device), n_rep)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = _sdpa_chunked(q, k, v, n_rep, window)
    elif window is None:
        out = flash_attention(q, k, v)
    else:
        out = flash_attention(q, k, v, window=window)
    y = out.reshape(b, t, cfg.n_heads * cfg.hd) @ p["wo"]
    return shard_act(y, "btd"), {"k": k, "v": v}


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    shape = (batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
               cfg: ModelConfig):
    """x: (B, 1, d); pos: absolute position of the new token. Writes the
    token's k and v into ``cache`` in place and returns it."""
    require_ported(cfg)
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    cache["k"][:, pos:pos + 1] = k
    cache["v"][:, pos:pos + 1] = v
    s = cache["k"].shape[1]
    mask = decode_mask(s, pos, cfg.sliding_window, device=x.device)[None, :]
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg.n_heads // cfg.kv_heads)
    y = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# Full attention (whisper): no RoPE, every key attended, through the plain
# ``_sdpa`` at any length, as the reference (K9 is causal only)
# ---------------------------------------------------------------------------


def encoder_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's self-attention (``transformer.py``'s non-causal
    branch of the reference): every frame attends to every frame."""
    require_ported(cfg)
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.kv_heads)
    return out.reshape(b, t, -1) @ p["wo"]


def cross_forward(p: dict, x: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full attention of x (B, T, d) over the encoder's memory (B, S, d)."""
    require_ported(cfg)
    b, t, _ = x.shape
    s = memory.shape[1]
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, t, h, hd)
    k = (memory @ p["wk"]).reshape(b, s, kv, hd)
    v = (memory @ p["wv"]).reshape(b, s, kv, hd)
    mask = torch.ones((t, s), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, h // kv)
    return out.reshape(b, t, h * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention). Its q.k spans nope + rope dims (96 in
# MiniCPM3) against v's 64, so it takes no K9: the reference's own path,
# chunked above 2 * SDPA_CHUNK tokens.
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m, d, h, dt = cfg.mla, cfg.d_model, cfg.n_heads, cfg.tdtype
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wdq": dense_init(gen, d, m.q_lora_rank, dt),
        "wuq": dense_init(gen, m.q_lora_rank, h * qd, dt),
        "wdkv": dense_init(gen, d, m.kv_lora_rank, dt),
        "wkrope": dense_init(gen, d, m.qk_rope_dim, dt),
        "wuk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_dim, dt),
        "wuv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dt),
        "wo": dense_init(gen, h * m.v_head_dim, d, dt,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _mla_qk(p: dict, x: torch.Tensor, positions, cfg: ModelConfig):
    m = cfg.mla
    b, t, _ = x.shape
    q = ((x @ p["wdq"]) @ p["wuq"]).reshape(
        b, t, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ p["wdkv"]                                  # (b, t, kv_lora)
    krope = apply_rope((x @ p["wkrope"])[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]       # (b, t, rope_dim)
    return q_nope, q_rope, ckv, krope


def _mla_attend(p: dict, q_nope, q_rope, ckv, krope, mask,
                cfg: ModelConfig) -> torch.Tensor:
    """Queries (B, T, H, nope / rope) over the latent keys ckv (B, S,
    kv_lora) and krope (B, S, rope); mask (T, S) or (B, T, S) bool.
    Returns the output projection (B, T, d)."""
    m = cfg.mla
    b, t, h, _ = q_nope.shape
    s = ckv.shape[1]
    k_nope = (ckv @ p["wuk"]).reshape(b, s, h, m.qk_nope_dim)
    v = (ckv @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
    scores = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope)
              + torch.einsum("bthd,bsd->bhts", q_rope, krope)).float()
    scores = scores / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", w, v)
    return out.reshape(b, t, h * m.v_head_dim) @ p["wo"]


def _mla_attend_chunked(p: dict, q_nope, q_rope, ckv, krope, cfg: ModelConfig,
                        chunk: int = SDPA_CHUNK) -> torch.Tensor:
    """``_mla_attend`` with the causal mask over query chunks, each
    recomputed in the backward (``checkpoint``), as ``_sdpa_chunked``."""
    t = q_nope.shape[1]
    pad = (-t) % chunk
    if pad:
        q_nope, q_rope = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (q_nope, q_rope))
    j = torch.arange(t, device=q_nope.device)

    def one_chunk(qn, qr, start: int):
        qpos = start + torch.arange(chunk, device=qn.device)
        return _mla_attend(p, qn, qr, ckv, krope, j[None, :] <= qpos[:, None],
                           cfg)

    out = [checkpoint(one_chunk, qn, qr, start, use_reentrant=False)
           for qn, qr, start in zip(q_nope.split(chunk, dim=1),
                                    q_rope.split(chunk, dim=1),
                                    range(0, q_nope.shape[1], chunk))]
    return torch.cat(out, dim=1)[:, :t]


def mla_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions=None):
    require_ported(cfg)
    t = x.shape[1]
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q_nope, q_rope, ckv, krope = _mla_qk(p, x, positions, cfg)
    if t > 2 * SDPA_CHUNK:
        y = _mla_attend_chunked(p, q_nope, q_rope, ckv, krope, cfg)
    else:
        mask = causal_mask(t, cfg.sliding_window, device=x.device)
        y = _mla_attend(p, q_nope, q_rope, ckv, krope, mask, cfg)
    return shard_act(y, "btd"), {"ckv": ckv, "krope": krope}


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=cfg.tdtype, device=device),
            "krope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                 dtype=cfg.tdtype, device=device)}


def mla_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
               cfg: ModelConfig):
    """As ``gqa_decode``: the token's latent entries go into ``cache`` in
    place."""
    require_ported(cfg)
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv, krope = _mla_qk(p, x, posv, cfg)
    cache["ckv"][:, pos:pos + 1] = ckv
    cache["krope"][:, pos:pos + 1] = krope
    mask = decode_mask(cache["ckv"].shape[1], pos, device=x.device)[None, :]
    y = _mla_attend(p, q_nope, q_rope, cache["ckv"], cache["krope"], mask, cfg)
    return y, cache
