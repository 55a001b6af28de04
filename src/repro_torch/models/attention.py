"""Attention: GQA with RoPE and QKV bias, with the prefill forward and
single-token decode against a KV cache, the counterparts of the GQA part
of ``src/repro/models/attention.py``. Sliding windows, MLA and
cross-attention wait for ROADMAP Queue A item 12.

Cache layout: {"k": (B, S, KV, hd), "v": (B, S, KV, hd)}. Decode writes
the new token's k and v into the cache in place (the reference returns
an updated copy): a step then moves one token's keys, not the cache.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from .common import apply_rope, causal_mask, decode_mask, dense_init
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


def _sdpa_chunked(q, k, v, n_rep: int, chunk: int = SDPA_CHUNK):
    """Causal attention over query chunks, the reference's differentiable
    long-sequence attention. q: (B,T,H,hd) with query i at absolute
    position i; k/v: (B,T,KV,hd). T is padded up to a multiple of
    ``chunk``; each chunk attends to every key j <= its query's position
    and is recomputed in the backward (``checkpoint``, the counterpart of
    ``jax.checkpoint``), so the per-chunk softmax weights are not kept."""
    b, t, h, hd = q.shape
    pad = (-t) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    j = torch.arange(t, device=q.device)

    def one_chunk(qi, start: int):
        qpos = start + torch.arange(chunk, device=q.device)
        return _sdpa(qi, k, v, j[None, :] <= qpos[:, None], n_rep)

    out = [checkpoint(one_chunk, qi, start, use_reentrant=False)
           for qi, start in zip(q.split(chunk, dim=1),
                                range(0, q.shape[1], chunk))]
    return torch.cat(out, dim=1)[:, :t]


def gqa_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Above 2 * SDPA_CHUNK tokens the reference runs ``_sdpa_chunked``;
    so does the port while autograd records (K9 has no backward), and
    every other call runs the flash-attention kernel (K9)."""
    require_ported(cfg)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.kv_heads
    if t <= 2 * SDPA_CHUNK:
        out = _sdpa(q, k, v, causal_mask(t, device=x.device), n_rep)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = _sdpa_chunked(q, k, v, n_rep)
    else:
        out = flash_attention(q, k, v)
    y = out.reshape(b, t, cfg.n_heads * cfg.hd) @ p["wo"]
    return y, {"k": k, "v": v}


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
    mask = decode_mask(s, pos, device=x.device)[None, :]        # (1, S)
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg.n_heads // cfg.kv_heads)
    y = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return y, cache
