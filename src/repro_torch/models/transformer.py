"""Model assembly for the dense decoder family: init, the prefill forward
and loss, and single-token decode against a KV cache, the counterparts of
``src/repro/models/transformer.py``.

Parameters are the reference's tree of plain tensors: the layers are
stacked on a leading axis in ``layers[0]`` (the dense family's period is
one layer), and the layer loop is a Python loop over that axis, where
the reference scans. With ``use_remat`` (the default, as the
reference's) each layer runs under ``torch.utils.checkpoint`` while
autograd records, so the backward keeps one (B, T, d) input per layer
and recomputes the rest; a call without a gradient runs the layers
directly. The other families (moe, hybrid, ssm, encdec, vlm) wait for
ROADMAP Queue A item 12.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from . import attention as attn
from . import mlp as ff
from .common import apply_norm, cross_entropy, embed_init, norm_params
from .config import ModelConfig, require_ported

Params = Dict[str, Any]


def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt, dev = cfg.tdtype, gen.device
    return {"norm1": norm_params(cfg.d_model, cfg.norm, dt, dev),
            "mixer": attn.gqa_init(gen, cfg),
            "norm2": norm_params(cfg.d_model, cfg.norm, dt, dev),
            "ffn": ff.mlp_init(gen, cfg)}


def _layer_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = apply_norm(x, p["norm1"], cfg.norm)
    y, _ = attn.gqa_forward(p["mixer"], h, cfg)
    x = x + y
    h2 = apply_norm(x, p["norm2"], cfg.norm)
    return x + ff.mlp_forward(p["ffn"], h2, cfg)


def _layer_decode(p: Params, x: torch.Tensor, cache: dict, pos: int,
                  cfg: ModelConfig):
    h = apply_norm(x, p["norm1"], cfg.norm)
    y, cache = attn.gqa_decode(p["mixer"], h, cache, pos, cfg)
    x = x + y
    h2 = apply_norm(x, p["norm2"], cfg.norm)
    return x + ff.mlp_forward(p["ffn"], h2, cfg), cache


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked on its leading axis (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


class Model:
    """Functional model wrapper: params are explicit trees."""

    def __init__(self, cfg: ModelConfig, use_remat: bool = True):
        require_ported(cfg)
        self.cfg = cfg
        self.use_remat = use_remat

    # -- init ------------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> Params:
        """The reference's tree, drawn from ``generator`` with the
        reference's init laws, on the generator's device."""
        cfg, gen = self.cfg, generator
        params: Params = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.tdtype),
            "norm_f": norm_params(cfg.d_model, cfg.norm, cfg.tdtype, gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                           cfg.tdtype)
        layers = [_layer_init(gen, cfg) for _ in range(cfg.n_layers)]
        params["layers"] = [tree_map(lambda *xs: torch.stack(xs), *layers)]
        return params

    # -- forward -----------------------------------------------------------------

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(x, params["norm_f"], cfg.norm)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return torch.einsum("btd,vd->btv", x, head)

    def forward(self, params: Params, batch: dict):
        """Logits (B, T, V) of ``batch["tokens"]`` and the auxiliary loss
        (0 for the dense family), as the reference returns them."""
        x = params["embed"][batch["tokens"]]
        remat = (self.use_remat and torch.is_grad_enabled()
                 and any(t.requires_grad for t in tree_leaves(params)))
        for i in range(self.cfg.n_layers):
            p = _layer(params["layers"][0], i)
            if remat:
                x = checkpoint(_layer_forward, p, x, self.cfg,
                               use_reentrant=False)
            else:
                x = _layer_forward(p, x, self.cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), aux

    def loss_fn(self, params: Params, batch: dict) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        return cross_entropy(logits, batch["targets"])

    # -- serving -----------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """Per-layer KV caches stacked over the layers, as the reference's."""
        dev = resolve_device(device)
        c = attn.gqa_init_cache(self.cfg, batch, max_len, dev)
        return {"blocks": [tree_map(
            lambda a: a.expand((self.cfg.n_layers,) + a.shape).contiguous(), c)]}

    def decode_step(self, params: Params, cache: dict, token: torch.Tensor,
                    pos: int):
        """token: (B, 1) int; pos: absolute position. Returns (logits
        (B, 1, V), cache), the cache updated in place."""
        x = params["embed"][token]
        blocks = cache["blocks"][0]
        for i in range(self.cfg.n_layers):
            x, _ = _layer_decode(_layer(params["layers"][0], i), x,
                                 _layer(blocks, i), int(pos), self.cfg)
        return self._logits(params, x), cache


def build_model(cfg: ModelConfig, use_remat: bool = True) -> Model:
    return Model(cfg, use_remat=use_remat)
