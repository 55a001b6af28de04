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

Over a "model" axis (``common.model_axis()`` installed), GQA computes
this rank's heads: q/k/v column-parallel after ``copy_in``, ``wo``
row-parallel before ``reduce_out``. Where the heads do not split over
the ranks (the reference's ``bthd`` rule then replicates them), the layer
gathers the q/k/v columns whole (``gather_weight``) and computes every
head, and ``wo`` still takes this rank's rows of the whole output; where
only the KV heads do not split, it keeps its q heads and takes k/v
whole. The decode cache follows ``launch.sharding.cache_specs``: this
rank's KV heads, its slice of the sequence (each rank attends over its
slice and the ranks' (max, sum, out) are combined as a split softmax),
or the whole cache. MLA over the axis (``_MLAHeads``) computes this
rank's heads from its ``wuq`` columns (every head from ``wuq`` gathered
whole where H does not split), with ``wuk``/``wuv`` gathered whole from
their latent-row shards, the replicated down-projections' outputs
through ``copy_in`` and ``wo`` row-parallel; its decode takes the latent
cache whole or split on its sequence (``latent_seq``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from .common import (apply_rope, causal_mask, decode_mask, dense_init,
                     model_axis, shard_act)
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


def _attend(q, k, v, n_rep: int, window):
    """Causal (windowed) attention of the prefill: ``_sdpa`` up to
    2 * SDPA_CHUNK tokens; above, ``_sdpa_chunked`` while autograd
    records (K9 has no backward) and the flash-attention kernel (K9)
    otherwise."""
    t = q.shape[1]
    if t <= 2 * SDPA_CHUNK:
        return _sdpa(q, k, v, causal_mask(t, window, device=q.device), n_rep)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _sdpa_chunked(q, k, v, n_rep, window)
    if window is None:
        return flash_attention(q, k, v)
    return flash_attention(q, k, v, window=window)


def gqa_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Above 2 * SDPA_CHUNK tokens the reference runs ``_sdpa_chunked``;
    so does the port while autograd records (K9 has no backward), and
    every other call runs the flash-attention kernel (K9). Each branch
    takes the config's sliding window. Over a "model" axis, on this
    rank's heads (module docstring)."""
    require_ported(cfg)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    tp = model_axis()
    plan = None if tp is None else _TPHeads(cfg, tp)
    q, k, v = _qkv(p, x, cfg) if plan is None else plan.qkv(p, x)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = (shard_act(a, "bthd") for a in (q, k, v))
    if plan is None:
        out = _attend(q, k, v, cfg.n_heads // cfg.kv_heads,
                      cfg.sliding_window)
        y = out.reshape(b, t, cfg.n_heads * cfg.hd) @ p["wo"]
    else:
        ks, vs, n_rep = plan.kv_for_heads(k, v)
        out = _attend(q, ks, vs, n_rep, cfg.sliding_window)
        y = plan.out(out, p["wo"])
    return shard_act(y, "btd"), {"k": k, "v": v}


class _TPHeads:
    """The heads one rank computes over a "model" axis of M ranks.

    * ``q_whole``: H does not divide by M (or ``every_head``: a decode
      over a sequence-split cache), so q/k/v are gathered whole and every
      head computed; ``out`` takes this rank's H * hd / M
      columns of the whole output for its rows of ``wo``.
    * ``kv_whole``: KV does not divide by M (or q is whole), so k/v are
      whole and ``kv_for_heads`` picks the KV heads of this rank's q
      heads.
    Otherwise q and k/v are this rank's H / M and KV / M heads, and the
    GQA grouping is the whole layer's."""

    def __init__(self, cfg: ModelConfig, tp, every_head: bool = False):
        self.cfg, self.tp = cfg, tp
        m = tp.world
        self.q_whole = every_head or cfg.n_heads % m != 0
        self.kv_whole = self.q_whole or cfg.kv_heads % m != 0

    def qkv(self, p: dict, x: torch.Tensor, memory=None):
        """q, k, v (B, T, heads, hd) of the heads this rank computes; k
        and v of ``memory`` (B, S, d) where given (cross-attention), which
        passes ``copy_in`` as x does: each rank's heads give a part of its
        gradient, and the encoder's leaves that are whole over "model"
        need the sum."""
        cfg, tp = self.cfg, self.tp
        b, t, _ = x.shape
        x = tp.copy_in(x)
        mem = x if memory is None else tp.copy_in(memory)

        def w(name, whole, dim):
            return tp.gather_weight(p[name], dim) if whole else p[name]

        q = x @ w("wq", self.q_whole, 1)
        k = mem @ w("wk", self.kv_whole, 1)
        v = mem @ w("wv", self.kv_whole, 1)
        if cfg.qkv_bias:
            q = q + w("bq", self.q_whole, 0)
            k = k + w("bk", self.kv_whole, 0)
            v = v + w("bv", self.kv_whole, 0)
        s = mem.shape[1]
        return (q.reshape(b, t, -1, cfg.hd), k.reshape(b, s, -1, cfg.hd),
                v.reshape(b, s, -1, cfg.hd))

    def kv_for_heads(self, k, v):
        """(k, v, n_rep) for this rank's q heads: as they are where q and
        k/v are both split or both whole; where only k/v are whole, the
        KV heads of the rank's q heads (a contiguous range when the q
        heads cover whole groups or sit in one, else one KV head per q
        head, n_rep 1)."""
        cfg = self.cfg
        n_rep = cfg.n_heads // cfg.kv_heads
        if self.q_whole or not self.kv_whole:
            return k, v, n_rep
        count = cfg.n_heads // self.tp.world
        first = self.tp.rank * count
        lo, hi = first // n_rep, (first + count - 1) // n_rep + 1
        if first % n_rep == 0 and count % n_rep == 0:
            rep = n_rep
        elif hi - lo == 1:
            rep = count
        else:
            idx = torch.arange(first, first + count, device=k.device) // n_rep
            return (k.index_select(2, idx).contiguous(),
                    v.index_select(2, idx).contiguous(), 1)
        return (k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous(),
                rep)

    def out(self, out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        """The row-parallel output projection of the attention output
        (B, T, heads, hd), summed over the ranks."""
        b, t = out.shape[:2]
        flat = out.reshape(b, t, -1)
        if self.q_whole:
            cols = flat.shape[-1] // self.tp.world
            flat = flat.narrow(-1, self.tp.rank * cols, cols)
        return self.tp.reduce_out(flat @ wo)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    shape = (batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
               cfg: ModelConfig):
    """x: (B, 1, d); pos: absolute position of the new token. Writes the
    token's k and v into ``cache`` in place and returns it. Over a
    "model" axis, on this rank's part of the cache (module docstring)."""
    require_ported(cfg)
    b = x.shape[0]
    tp = model_axis()
    if tp is not None:
        return _decode_tp(p, x, cache, pos, cfg, tp)
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


def _decode_tp(p: dict, x: torch.Tensor, cache: dict, pos: int,
               cfg: ModelConfig, tp):
    """``gqa_decode`` over a "model" axis. The cache holds this rank's KV
    heads where KV divides by M; else, where it is marked ``kv_seq``
    (``Model.decode_step``), its slice of the sequence, and every rank
    computes every head over its slice (``_split_softmax``); else the
    whole cache."""
    b = x.shape[0]
    seq = cfg.kv_heads % tp.world != 0 and cache.get("kv_seq", False)
    plan = _TPHeads(cfg, tp, every_head=seq)
    q, k, v = plan.qkv(p, x)
    if cfg.rope:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.kv_heads
    if seq:
        s_loc = cache["k"].shape[1]
        lo = tp.rank * s_loc
        if lo <= pos < lo + s_loc:
            cache["k"][:, pos - lo:pos - lo + 1] = k
            cache["v"][:, pos - lo:pos - lo + 1] = v
        mask = decode_mask(s_loc * tp.world, pos, cfg.sliding_window,
                           device=x.device)[lo:lo + s_loc][None, :]
        out = _split_softmax(q, cache["k"], cache["v"], mask, n_rep, tp)
    else:
        cache["k"][:, pos:pos + 1] = k
        cache["v"][:, pos:pos + 1] = v
        mask = decode_mask(cache["k"].shape[1], pos, cfg.sliding_window,
                           device=x.device)[None, :]
        ks, vs, n_rep = plan.kv_for_heads(cache["k"], cache["v"])
        out = _sdpa(q, ks, vs, mask, n_rep)
    return plan.out(out, p["wo"]), cache


def _split_softmax(q, k, v, mask, n_rep: int, tp):
    """``_sdpa`` of every head over the whole cache when each rank holds
    a slice of its sequence (k/v (B, S / M, KV, hd), ``mask`` this slice's
    (1, S / M)), through ``_split_combine``."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, n_rep, hd)
    scores = torch.einsum("btkrh,bskh->bkrts", qg, k).float() / math.sqrt(hd)
    keep = mask[:, None, None, None, :] if mask.dim() == 2 else mask
    out = _split_combine(scores, keep, lambda e: torch.einsum(
        "bkrts,bskh->bkrth", e, v.float()), tp)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(v.dtype)


def _split_combine(scores, keep, weigh, tp):
    """The softmax-weighted output of ``scores`` (..., T, S / M), this
    rank's slice of the keys (``keep`` True where attendable), over every
    rank's slice: each rank's running max, sum of exp and unnormalized
    output ``weigh(e)`` (..., T, dv), gathered and combined in rank
    order, the same on every rank. A rank whose slice is all masked
    gives a sum and output of 0."""
    scores = torch.where(keep, scores, -1e30)
    mx = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - mx) * keep
    part = weigh(e)
    mxs, sums, outs = tp.gather(mx[None], e.sum(-1, keepdim=True)[None],
                                part[None])
    top = torch.amax(mxs, dim=0)
    scale = torch.exp(mxs - top)
    total = torch.sum(scale * sums, dim=0)
    return torch.sum(scale * outs, dim=0) / total


# ---------------------------------------------------------------------------
# Full attention (whisper): no RoPE, every key attended, through the plain
# ``_sdpa`` at any length, as the reference (K9 is causal only)
# ---------------------------------------------------------------------------


def _full_attention(p: dict, x: torch.Tensor, memory, cfg: ModelConfig):
    """Every query of x (B, T, d) over every key of ``memory`` (B, S, d),
    or of x itself where ``memory`` is None. Over a "model" axis, on this
    rank's heads (``_TPHeads``: every head where H does not split, with
    ``wo`` taking the rank's columns of their output)."""
    require_ported(cfg)
    b, t, _ = x.shape
    s = t if memory is None else memory.shape[1]
    mask = torch.ones((t, s), dtype=torch.bool, device=x.device)
    tp = model_axis()
    if tp is not None:
        plan = _TPHeads(cfg, tp)
        q, k, v = plan.qkv(p, x, memory)
        ks, vs, n_rep = plan.kv_for_heads(k, v)
        return plan.out(_sdpa(q, ks, vs, mask, n_rep), p["wo"])
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if memory is None:
        q, k, v = _qkv(p, x, cfg)
    else:
        q = (x @ p["wq"]).reshape(b, t, h, hd)
        k = (memory @ p["wk"]).reshape(b, s, kv, hd)
        v = (memory @ p["wv"]).reshape(b, s, kv, hd)
    out = _sdpa(q, k, v, mask, h // kv)
    return out.reshape(b, t, h * hd) @ p["wo"]


def encoder_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's self-attention (``transformer.py``'s non-causal
    branch of the reference): every frame attends to every frame."""
    return _full_attention(p, x, None, cfg)


def cross_forward(p: dict, x: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full attention of x (B, T, d) over the encoder's memory (B, S, d)."""
    return _full_attention(p, x, memory, cfg)


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


def _mla_qk(p: dict, x: torch.Tensor, positions, cfg: ModelConfig,
            plan=None):
    """q's nope and rope parts (B, T, heads, ...) and the latent keys ckv
    (B, T, kv_lora) and krope (B, T, rope_dim). With ``plan`` (over a
    "model" axis) the down-projections' outputs pass ``copy_in`` and q
    has the heads ``plan.wuq`` gives."""
    m = cfg.mla
    b, t, _ = x.shape
    cq, ckv, kr = x @ p["wdq"], x @ p["wdkv"], x @ p["wkrope"]
    wuq = p["wuq"]
    if plan is not None:
        cq, ckv, kr = (plan.tp.copy_in(a) for a in (cq, ckv, kr))
        wuq = plan.wuq(p)
    q = (cq @ wuq).reshape(b, t, -1, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    krope = apply_rope(kr[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]       # (b, t, rope_dim)
    return q_nope, q_rope, ckv, krope


def _mla_scores(p: dict, q_nope, q_rope, ckv, krope, cfg: ModelConfig):
    """The scaled f32 scores (B, H, T, S) of queries (B, T, H, nope /
    rope) over the latent keys, and v (B, S, H, v_head_dim)."""
    m = cfg.mla
    b, t, h, _ = q_nope.shape
    s = ckv.shape[1]
    k_nope = (ckv @ p["wuk"]).reshape(b, s, h, m.qk_nope_dim)
    v = (ckv @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
    scores = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope)
              + torch.einsum("bthd,bsd->bhts", q_rope, krope)).float()
    return scores / math.sqrt(m.qk_nope_dim + m.qk_rope_dim), v


def _mla_attend(p: dict, q_nope, q_rope, ckv, krope, mask,
                cfg: ModelConfig, cols=None) -> torch.Tensor:
    """Queries (B, T, H, nope / rope) over the latent keys ckv (B, S,
    kv_lora) and krope (B, S, rope); mask (T, S) or (B, T, S) bool.
    Returns the output projection (B, T, d); ``cols`` (start, size)
    narrows the heads' output to those columns before ``wo``."""
    b, t = q_nope.shape[:2]
    scores, v = _mla_scores(p, q_nope, q_rope, ckv, krope, cfg)
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, -1)
    if cols is not None:
        out = out.narrow(-1, *cols)
    return out @ p["wo"]


def _mla_attend_chunked(p: dict, q_nope, q_rope, ckv, krope, cfg: ModelConfig,
                        chunk: int = SDPA_CHUNK, cols=None) -> torch.Tensor:
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
                           cfg, cols)

    out = [checkpoint(one_chunk, qn, qr, start, use_reentrant=False)
           for qn, qr, start in zip(q_nope.split(chunk, dim=1),
                                    q_rope.split(chunk, dim=1),
                                    range(0, q_nope.shape[1], chunk))]
    return torch.cat(out, dim=1)[:, :t]


class _MLAHeads:
    """The heads one rank of a "model" axis of M ranks computes in MLA,
    on the reference's rules: ``wuq`` split on its columns, ``wuk`` and
    ``wuv`` on their rows (the latent rank), ``wo`` on its rows, the
    down-projections whole.

    * q: this rank's H / M heads from its ``wuq`` columns where H divides
      by M; else (``q_whole``; or ``every_head``, a decode over a
      sequence-split cache) ``wuq`` whole and every head;
    * ``wuk`` / ``wuv`` whole (``weight_whole``: 1.3 MB a layer in bf16 at
      minicpm3-4b's width, where the row-parallel alternative would sum
      (B, S, H * nope) partials) and narrowed to the heads of q;
    * the output: this rank's H * v_head_dim / M columns (its heads', or
      ``cols`` of every head's) through its rows of ``wo``, summed over
      the ranks (``reduce_out``)."""

    def __init__(self, cfg: ModelConfig, tp, every_head: bool = False):
        self.cfg, self.tp = cfg, tp
        self.q_whole = every_head or cfg.n_heads % tp.world != 0
        width = cfg.n_heads * cfg.mla.v_head_dim // tp.world
        self.cols = (tp.rank * width, width) if self.q_whole else None

    def wuq(self, p: dict) -> torch.Tensor:
        m = self.cfg.mla
        if not self.q_whole:
            return p["wuq"]
        return self.tp.weight_whole(p["wuq"], 1, self.cfg.n_heads * (
            m.qk_nope_dim + m.qk_rope_dim))

    def weights(self, p: dict) -> dict:
        """``wuk``, ``wuv`` (the heads of q) and ``wo`` as ``_mla_attend``
        takes them."""
        cfg, tp = self.cfg, self.tp
        out = {"wo": p["wo"]}
        for name, hd in (("wuk", cfg.mla.qk_nope_dim),
                         ("wuv", cfg.mla.v_head_dim)):
            w = tp.weight_whole(p[name], 0, cfg.mla.kv_lora_rank)
            if not self.q_whole:
                w = tp.part(w, 1)
            out[name] = w
        return out


def mla_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Over a "model" axis, on this rank's heads (``_MLAHeads``): the
    down-projections' outputs through ``copy_in`` (their weights are
    whole over "model", so their gradients must be every rank's heads'),
    ``wo`` row-parallel before ``reduce_out``."""
    require_ported(cfg)
    t = x.shape[1]
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    tp = model_axis()
    plan = None if tp is None else _MLAHeads(cfg, tp)
    q_nope, q_rope, ckv, krope = _mla_qk(p, x, positions, cfg, plan)
    w, cols = (p, None) if plan is None else (plan.weights(p), plan.cols)
    if t > 2 * SDPA_CHUNK:
        y = _mla_attend_chunked(w, q_nope, q_rope, ckv, krope, cfg, cols=cols)
    else:
        mask = causal_mask(t, cfg.sliding_window, device=x.device)
        y = _mla_attend(w, q_nope, q_rope, ckv, krope, mask, cfg, cols)
    if plan is not None:
        y = tp.reduce_out(y)
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
    place. Over a "model" axis, ``_mla_decode_tp``."""
    require_ported(cfg)
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    tp = model_axis()
    if tp is not None:
        return _mla_decode_tp(p, x, cache, pos, posv, cfg, tp)
    q_nope, q_rope, ckv, krope = _mla_qk(p, x, posv, cfg)
    cache["ckv"][:, pos:pos + 1] = ckv
    cache["krope"][:, pos:pos + 1] = krope
    mask = decode_mask(cache["ckv"].shape[1], pos, device=x.device)[None, :]
    y = _mla_attend(p, q_nope, q_rope, cache["ckv"], cache["krope"], mask, cfg)
    return y, cache


def _mla_decode_tp(p: dict, x: torch.Tensor, cache: dict, pos: int, posv,
                   cfg: ModelConfig, tp):
    """``mla_decode`` over a "model" axis, on the latent cache as
    ``launch.sharding.cache_specs`` lays it out. Where it is marked
    ``latent_seq`` (``Model.decode_step``: the sequence splits over the
    ranks), each rank holds S / M positions and writes the token's entry
    only where its slice holds ``pos``; it computes its heads' q (or
    every head where H does not split) and gathers q over the ranks (an
    activation of B x H x (nope + rope), not ``wuq``), scores every head
    over its slice and combines the ranks' (max, sum, out)
    (``_split_combine``), then takes its heads' columns into its rows of
    ``wo``. Else the cache is whole and each rank computes its heads."""
    seq = cache.get("latent_seq", False)
    plan = _MLAHeads(cfg, tp)
    q_nope, q_rope, ckv, krope = _mla_qk(p, x, posv, cfg, plan)
    if not seq:
        cache["ckv"][:, pos:pos + 1] = ckv
        cache["krope"][:, pos:pos + 1] = krope
        mask = decode_mask(cache["ckv"].shape[1], pos, device=x.device)[None]
        y = _mla_attend(plan.weights(p), q_nope, q_rope, cache["ckv"],
                        cache["krope"], mask, cfg, plan.cols)
        return tp.reduce_out(y), cache
    s_loc = cache["ckv"].shape[1]
    lo = tp.rank * s_loc
    if lo <= pos < lo + s_loc:
        cache["ckv"][:, pos - lo:pos - lo + 1] = ckv
        cache["krope"][:, pos - lo:pos - lo + 1] = krope
    if not plan.q_whole:
        nope = q_nope.shape[-1]
        q = tp.whole(torch.cat([q_nope, q_rope], dim=-1), 2)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
    every = _MLAHeads(cfg, tp, every_head=True)
    b = x.shape[0]
    scores, v = _mla_scores(every.weights(p), q_nope, q_rope, cache["ckv"], cache["krope"],
                            cfg)
    mask = decode_mask(s_loc * tp.world, pos, device=x.device)[lo:lo + s_loc]
    out = _split_combine(scores, mask[None, None, None, :], lambda e: (
        torch.einsum("bhts,bshd->bhtd", e, v.float())), tp)
    out = out.permute(0, 2, 1, 3).reshape(b, 1, -1).to(v.dtype)
    return tp.reduce_out(out.narrow(-1, *every.cols) @ p["wo"]), cache
