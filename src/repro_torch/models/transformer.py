"""Model assembly: init, the prefill forward and loss, and single-token
decode against a cache, the counterparts of
``src/repro/models/transformer.py`` for every family of the reference:

  dense | moe : uniform decoder blocks (GQA or MLA; an MLP, or an MoE
                feed-forward in every layer)
  hybrid      : jamba periods, attn_every - 1 Mamba layers and one
                attention layer, MoE on the odd layers
  ssm         : xLSTM periods, slstm_every - 1 mLSTM blocks and one
                sLSTM; no feed-forward where d_ff is 0
  encdec      : whisper, an encoder stack over (stubbed) frame embeddings
                and a decoder whose layers add cross-attention over the
                encoder's output, sinusoidal positions on both
  vlm         : llava, the dense decoder over [patch embeddings ; tokens],
                the loss on the text positions only

Parameters are the reference's tree of plain tensors: ``layers`` is a
list of one stack per position in the period (``period_len``: one layer
for the uniform families), each stacked over the ``n_layers / period``
segments on its leading axis; the encoder's layers are stacked in
``enc_layers``. The layer loop is a Python loop over segments, then
positions, where the reference scans over segments. With ``use_remat``
(the default, as the reference's) each layer runs under
``torch.utils.checkpoint`` while autograd records, so the backward keeps
one (B, T, d) input per layer and recomputes the rest; a call without a
gradient runs the layers directly. Each layer's slice passes through
``shard_layer_params`` inside the checkpointed function, and the weights
outside the stacks through it once a forward: on a mesh, the train
driver's hook gathers the split weights there, a layer at a time. Over
a "model" axis (``common.model_axis()``), the embedding lookup and the
logits are vocab-parallel (each rank its V / M rows; the loss is
``vocab_parallel_cross_entropy``) where the axis divides the vocab, and
whole on every rank where the rules replicate the table
(``common.vocab_axis``); the layers split heads and d_ff (an MoE its
experts, or each expert's d_ff; a Mamba mixer its channels; an mLSTM
its heads, while an sLSTM runs its recurrence whole on every rank), and
the residual between segments keeps this rank's T / M rows (the
``carry`` hint: a VLM's patches and tokens together, the encoder's
frames), gathered again inside the next layer. The encoder's memory is
whole on every rank; the cross-attention takes it through ``copy_in``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from . import attention as attn
from . import mamba as mam
from . import mlp as ff
from . import xlstm as xl
from .common import (apply_norm, cross_entropy, embed_init, gather_carry,
                     norm_params, shard_act, shard_layer_params, vocab_axis,
                     vocab_parallel_cross_entropy)
from .config import ModelConfig, require_ported

Params = Dict[str, Any]


class Mixer(NamedTuple):
    init: Callable
    forward: Callable
    decode: Callable
    init_cache: Callable


def _recurrent(init, forward, decode, init_cache) -> Mixer:
    """A recurrent mixer in the ``Mixer`` form: its forward returns y
    alone (no KV cache), its decode takes no position and its cache no
    length."""
    return Mixer(init,
                 lambda p, x, cfg: (forward(p, x, cfg), None),
                 lambda p, x, cache, pos, cfg: decode(p, x, cache, cfg),
                 lambda cfg, batch, max_len, device: init_cache(cfg, batch,
                                                                device))


MIXERS = {"attn": Mixer(attn.gqa_init, attn.gqa_forward, attn.gqa_decode,
                        attn.gqa_init_cache),
          "mla": Mixer(attn.mla_init, attn.mla_forward, attn.mla_decode,
                       attn.mla_init_cache),
          "mamba": _recurrent(mam.mamba_init, mam.mamba_forward,
                              mam.mamba_decode, mam.mamba_init_cache),
          "mlstm": _recurrent(xl.mlstm_init, xl.mlstm_forward,
                              xl.mlstm_decode, xl.mlstm_init_cache),
          "slstm": _recurrent(xl.slstm_init, xl.slstm_forward,
                              xl.slstm_decode, xl.slstm_init_cache)}


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """The (mixer, ffn) kind of every decoder layer, as the reference's:
    hybrid puts attention last in each run of attn_every layers and MoE
    on the odd layers; ssm an sLSTM last in each run of slstm_every and
    no feed-forward ("none") where d_ff is 0; the other families repeat
    one kind."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.family == "hybrid":
            mixer = ("attn" if i % cfg.attn_every == cfg.attn_every - 1
                     else "mamba")
            ffn = "moe" if cfg.moe is not None and i % cfg.moe_every == 1 \
                else "mlp"
        elif cfg.family == "ssm":
            every = cfg.xlstm.slstm_every
            mixer = "slstm" if i % every == every - 1 else "mlstm"
            ffn = "none" if cfg.d_ff == 0 else "mlp"
        else:
            mixer = "mla" if cfg.attn_type == "mla" else "attn"
            ffn = "moe" if cfg.moe is not None else "mlp"
        kinds.append((mixer, ffn))
    return kinds


def period_len(cfg: ModelConfig) -> int:
    """Layers per segment: the period of ``layer_kinds`` (1 for the
    uniform stacks). A hybrid stack cut below one period (jamba's first
    two layers, Mamba + MLP and Mamba + MoE, which the reference's model
    refuses) is one segment of its ``n_layers`` layers."""
    if cfg.family == "hybrid":
        p = cfg.attn_every
        if cfg.moe is not None:
            p = max(p, 2) if p % 2 == 0 else p * 2
        return min(p, cfg.n_layers)
    if cfg.family == "ssm":
        return cfg.xlstm.slstm_every
    return 1


# ---------------------------------------------------------------------------
# Single-layer init / forward / decode
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str,
                cross: bool) -> Params:
    """One layer's tree: ``ffn`` "none" has no ``norm2`` and no ``ffn``."""
    dt, dev = cfg.tdtype, gen.device
    p = {"norm1": norm_params(cfg.d_model, cfg.norm, dt, dev),
         "mixer": MIXERS[mixer].init(gen, cfg)}
    if ffn != "none":
        p["norm2"] = norm_params(cfg.d_model, cfg.norm, dt, dev)
        p["ffn"] = (ff.moe_init(gen, cfg) if ffn == "moe"
                    else ff.mlp_init(gen, cfg))
    if cross:
        p["norm_x"] = norm_params(cfg.d_model, cfg.norm, dt, dev)
        p["cross"] = attn.gqa_init(gen, cfg)
    return p


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, ffn: str):
    """The block's feed-forward half: x + FFN(norm2(x)), and the MoE's
    aux loss (0 for an MLP); x itself for "none"."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, zero
    h = apply_norm(x, p["norm2"], cfg.norm)
    if ffn == "moe":
        y, aux = ff.moe_forward(p["ffn"], h, cfg)
        return x + y, aux
    return x + ff.mlp_forward(p["ffn"], h, cfg), zero


def _cross(p: Params, x: torch.Tensor, memory, cfg: ModelConfig):
    if memory is None:
        return x
    hx = apply_norm(x, p["norm_x"], cfg.norm)
    return x + attn.cross_forward(p["cross"], hx, memory, cfg)


def _layer_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, mixer: str,
                   ffn: str, memory: Optional[torch.Tensor] = None,
                   causal: bool = True):
    """Self-attention, then cross-attention over ``memory`` (encdec), then
    the feed-forward. Returns (x, aux)."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    if causal:
        y, _ = MIXERS[mixer].forward(p["mixer"], h, cfg)
    else:  # the encoder's self-attention
        y = attn.encoder_forward(p["mixer"], h, cfg)
    return _ffn(p, _cross(p, x + y, memory, cfg), cfg, ffn)


def _layer_decode(p: Params, x: torch.Tensor, cache: dict, pos: int,
                  cfg: ModelConfig, mixer: str, ffn: str,
                  memory: Optional[torch.Tensor] = None):
    h = apply_norm(x, p["norm1"], cfg.norm)
    y, cache = MIXERS[mixer].decode(p["mixer"], h, cache, pos, cfg)
    x, _ = _ffn(p, _cross(p, x + y, memory, cfg), cfg, ffn)
    return x, cache


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked on its leading axis (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def _slice_forward(p: Params, x: torch.Tensor, t: int, *args):
    """``_layer_forward`` of a layer's slice as ``shard_layer_params``
    gives it, on x whole over its ``t`` rows (``gather_carry``): inside a
    checkpoint, the backward gathers both again."""
    return _layer_forward(shard_layer_params(p), gather_carry(x, t), *args)


def _embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """``table[tokens]``; over a "model" axis that splits the vocab
    (``vocab_axis``) ``table`` is this rank's block of V / M rows: the
    rows it owns, zeros for the others, summed over the ranks (one
    nonzero term a row, so exact)."""
    tp = vocab_axis(vocab)
    if tp is None:
        return table[tokens]
    v = table.shape[0]
    t = tokens - tp.rank * v
    mine = ((t >= 0) & (t < v))[..., None].to(table.dtype)
    return tp.reduce_out(table[t.clamp(0, v - 1)] * mine)


_STACKS = ("layers", "enc_layers")
# a cache's marks that its sequence is split over the "model" axis: GQA's
# KV caches, MLA's latent caches
_SEQ_MARKS = ("kv_seq", "latent_seq")


def _kept(tree, path: str, keep, lead: tuple = ()):
    """``tree``'s leaves through ``keep(path, whole_shape, x)`` (the
    whole leaf's shape is ``lead`` + x's: a layer of a stack of ``lead``
    layers); ``tree`` itself without ``keep``."""
    if keep is None:
        return tree
    if isinstance(tree, dict):
        return {k: _kept(v, f"{path}/{k}", keep, lead)
                for k, v in tree.items()}
    return keep(path, lead + tuple(tree.shape), tree)


def _stacked(makes: list, n: int, keep=None, paths=None) -> list:
    """``n`` segments of the layers that ``makes`` draw (one maker per
    position in the period), drawn segment by segment and each layer
    written into preallocated leaves stacked on a leading axis: the peak
    is the stacks and one layer, not two stacks. Returns one stack per
    position. ``keep`` (``Model.init_params``) narrows each drawn layer
    before it is written (position j's leaves under ``paths[j]``)."""
    out = [None] * len(makes)
    for i in range(n):
        for j, make in enumerate(makes):
            layer = _kept(make(), paths[j] if keep else "", keep, (n,))
            if out[j] is None:
                out[j] = tree_map(
                    lambda a: a.new_empty((n,) + tuple(a.shape)), layer)
            tree_map(lambda o, a: o[i].copy_(a), out[j], layer)
            del layer
    return out


# ---------------------------------------------------------------------------
# Sinusoidal positions (whisper: any length, no table), in f32
# ---------------------------------------------------------------------------


def _inv_timescales(d: int, device) -> torch.Tensor:
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return 10000.0 ** (2 * dim / d)


def sinusoid(t: int, d: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """(t, d): sin then cos of pos / 10000^(2i/d), i < d/2."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    ang = pos / _inv_timescales(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoid_at(pos: int, d: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """(d,): row ``pos`` of ``sinusoid``."""
    pos = torch.tensor(float(pos), dtype=torch.float32, device=device)
    ang = pos / _inv_timescales(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model:
    """Functional model wrapper: params are explicit trees."""

    def __init__(self, cfg: ModelConfig, use_remat: bool = True):
        require_ported(cfg)
        self.cfg = cfg
        self.use_remat = use_remat
        self.period = period_len(cfg)
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.n_layers} layers are not whole periods "
                             f"of {self.period}")
        self.n_segments = cfg.n_layers // self.period
        self.kinds = layer_kinds(cfg)[:self.period]   # every period's
        self.cross = cfg.family == "encdec"

    # -- init ------------------------------------------------------------------

    def init_params(self, generator: torch.Generator, keep=None) -> Params:
        """The reference's tree, drawn from ``generator`` with the
        reference's init laws, on the generator's device: the embeddings,
        then the decoder's layers one by one (segment by segment, each
        position of the period in turn), then the encoder's. ``keep(path,
        whole_shape, x)`` (``launch.sharding.local_keep``) takes each
        drawn leaf, a layer of a stacked one at a time, and returns what
        is kept of it (a rank's shard): the draws are the whole tree's,
        but no more than one layer of it is held whole."""
        cfg, gen = self.cfg, generator
        params: Params = _kept({
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.tdtype),
            "norm_f": norm_params(cfg.d_model, cfg.norm, cfg.tdtype, gen.device),
        }, "params", keep)
        if not cfg.tie_embeddings:
            params["lm_head"] = _kept(embed_init(gen, cfg.vocab, cfg.d_model,
                                                 cfg.tdtype),
                                      "params/lm_head", keep)
        params["layers"] = _stacked(
            [lambda kind=kind: _layer_init(gen, cfg, *kind, self.cross)
             for kind in self.kinds], self.n_segments, keep,
            [f"params/layers/{j}" for j in range(self.period)])
        if self.cross:
            params["enc_layers"], = _stacked(
                [lambda: _layer_init(gen, cfg, "attn", "mlp", False)],
                cfg.enc_layers, keep, ["params/enc_layers"])
            params["enc_norm_f"] = _kept(
                norm_params(cfg.d_model, cfg.norm, cfg.tdtype, gen.device),
                "params/enc_norm_f", keep)
        return params

    # -- forward -----------------------------------------------------------------

    def _run(self, params: Params, stacks: list, kinds: list, n: int,
             x: torch.Tensor, memory=None, causal: bool = True):
        """``n`` segments over x, each the layers of ``kinds`` in turn from
        their ``stacks``; returns (x, the sum of their aux losses)."""
        remat = (self.use_remat and torch.is_grad_enabled()
                 and any(t.requires_grad for t in tree_leaves(params)))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        t = x.shape[1]
        for i in range(n):
            for stack, kind in zip(stacks, kinds):
                args = (_layer(stack, i), x, t, self.cfg, *kind, memory,
                        causal)
                if remat:
                    x, a = checkpoint(_slice_forward, *args,
                                      use_reentrant=False)
                else:
                    x, a = _slice_forward(*args)
                aux = aux + a
            x = shard_act(x, "carry")
        return gather_carry(x, t), aux

    def _embed_inputs(self, params: Params, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = _embed_lookup(params["embed"], batch["tokens"], cfg.vocab)
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        if self.cross:
            x = x + sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)
        return shard_act(x, "btd")

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder stack over frame embeddings (B, S, d), then its
        final norm: the decoder's memory."""
        cfg = self.cfg
        x = frames.to(cfg.tdtype) + sinusoid(frames.shape[1], cfg.d_model,
                                             cfg.tdtype, frames.device)
        x, _ = self._run(params, [params["enc_layers"]], [("attn", "mlp")],
                         cfg.enc_layers, x, causal=False)
        return apply_norm(x, params["enc_norm_f"], cfg.norm)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(x, params["norm_f"], cfg.norm)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        tp = vocab_axis(cfg.vocab)
        if tp is not None:
            x = tp.copy_in(x)
        return shard_act(torch.einsum("btd,vd->btv", x, head), "logits")

    def forward(self, params: Params, batch: dict):
        """Logits (B, T, V) of the batch (``tokens``; ``patches`` before
        them for vlm, ``frames`` for the encoder of encdec) and the sum of
        the layers' aux losses (0 without MoE), as the reference returns
        them. The weights outside the stacks pass ``shard_layer_params``
        once, before the layers."""
        params = {k: v if k in _STACKS else shard_layer_params(v)
                  for k, v in params.items()}
        memory = (self._encode(params, batch["frames"]) if self.cross
                  else None)
        x = self._embed_inputs(params, batch)
        x, aux = self._run(params, params["layers"], self.kinds,
                           self.n_segments, x, memory)
        return self._logits(params, x), aux

    def loss_fn(self, params: Params, batch: dict) -> torch.Tensor:
        """Cross-entropy (vlm: on the text positions only), plus
        ``router_aux_weight`` times the aux loss with MoE."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        if cfg.family == "vlm":
            logits = logits[:, cfg.vision_tokens:]
        tp = vocab_axis(cfg.vocab)
        if tp is None:
            loss = cross_entropy(logits, batch["targets"])
        else:
            loss = vocab_parallel_cross_entropy(logits, batch["targets"], tp)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux
        return loss

    # -- serving -----------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """One cache per position in the period, stacked over the segments,
        as the reference's: KV caches (latent caches for MLA), a Mamba
        layer's conv window and SSM state, an mLSTM's (C, n, m), an
        sLSTM's (c, n, h, m); for encdec the encoder's memory ``enc``
        (B, enc_seq, d), zeros until the caller fills it. Whoever lays
        the KV caches out over a "model" axis with their sequence split
        (``cache_specs``) sets ``kv_seq`` True beside ``blocks``, and
        ``latent_seq`` for MLA's latent caches."""
        cfg = self.cfg
        dev = resolve_device(device)
        blocks = []
        for mixer, _ in self.kinds:
            c = MIXERS[mixer].init_cache(cfg, batch, max_len, dev)
            blocks.append(tree_map(lambda a: a.expand(
                (self.n_segments,) + a.shape).contiguous(), c))
        cache = {"blocks": blocks}
        if self.cross:
            cache["enc"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                       dtype=cfg.tdtype, device=dev)
        return cache

    def decode_step(self, params: Params, cache: dict, token: torch.Tensor,
                    pos: int):
        """token: (B, 1) int; pos: absolute position. Returns (logits
        (B, 1, V), cache), the cache updated in place. MoE routes the B
        tokens of the step as one group; the aux loss is dropped, as in
        the reference. The layers run segment by segment, each position
        of the period in turn; a recurrent mixer writes its new state
        into its slot of the stacked cache. The marks ``kv_seq`` and
        ``latent_seq`` reach each layer's cache."""
        cfg = self.cfg
        x = _embed_lookup(params["embed"], token, cfg.vocab)
        memory = cache["enc"] if self.cross else None
        mark = {k: True for k in _SEQ_MARKS if cache.get(k, False)}
        if self.cross:
            x = x + sinusoid_at(pos, cfg.d_model, x.dtype, x.device)
        for i in range(self.n_segments):
            for stack, blocks, kind in zip(params["layers"], cache["blocks"],
                                           self.kinds):
                blk = _layer(blocks, i)
                x, _ = _layer_decode(_layer(stack, i), x,
                                     {**blk, **mark} if mark else blk,
                                     int(pos), cfg, *kind, memory)
        return self._logits(params, x), cache


def build_model(cfg: ModelConfig, use_remat: bool = True) -> Model:
    return Model(cfg, use_remat=use_remat)
