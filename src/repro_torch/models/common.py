"""Shared building blocks: the sharding hooks, initializers, norms,
RoPE, masks and the loss, the counterparts of
``src/repro/models/common.py``.

The hooks are the identity until a launcher installs them
(``set_activation_sharder``): the train driver on a mesh installs
``launch.sharding.make_activation_constraint``,
``make_layer_param_constrainer`` and ``make_model_axis``, and the
model's loop then gathers each layer's "data"-split weights as it
reaches the layer, while the layers compute on their own "model" shards
through the installed ``model_axis()``'s operators. Initializers draw
from an explicit ``torch.Generator`` and put the weights on its device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Sharding hooks: the launcher installs them; the models call shard_act(x,
# kind) where the reference does, and shard_layer_params on each layer's
# slice inside the loop and on the weights outside the stacks.
# ---------------------------------------------------------------------------

_ACT_CONSTRAINT = None          # (tensor, kind) -> tensor, or None
_LAYER_PARAM_CONSTRAINT = None  # (tree) -> tree, or None
_MODEL_AXIS = None              # launch.sharding.ModelAxis, or None


def set_activation_sharder(fn, layer_param_fn=None, model_axis=None) -> None:
    """Install the hooks (None clears each): the activation hint, the
    per-layer weight gather and the "model" axis the layers split their
    heads, ffn columns and vocab over (None: every layer whole)."""
    global _ACT_CONSTRAINT, _LAYER_PARAM_CONSTRAINT, _MODEL_AXIS
    _ACT_CONSTRAINT = fn
    _LAYER_PARAM_CONSTRAINT = layer_param_fn
    _MODEL_AXIS = model_axis


def installed_hooks() -> tuple:
    """The three installed hooks, for a caller that installs its own and
    puts these back after."""
    return _ACT_CONSTRAINT, _LAYER_PARAM_CONSTRAINT, _MODEL_AXIS


def model_axis():
    """The installed ``ModelAxis`` (tensor parallelism over "model"), or
    None."""
    return _MODEL_AXIS


def vocab_axis(vocab: int):
    """The installed ``ModelAxis`` where a vocab of ``vocab`` rows splits
    over it (the embedding lookup, logits, loss and argmax are then
    vocab-parallel); None without one, or where the rules replicate the
    table because the axis does not divide it (granite's 49,155): every
    rank then computes the whole product."""
    if _MODEL_AXIS is None or vocab % _MODEL_AXIS.world:
        return None
    return _MODEL_AXIS


def gather_carry(x: torch.Tensor, t: int) -> torch.Tensor:
    """A layer's input whole over T (``t`` rows) where the ``carry`` hint
    left this rank its T / M rows; x itself where it is whole."""
    if _MODEL_AXIS is None or x.shape[1] == t:
        return x
    return _MODEL_AXIS.gather_seq(x)


def shard_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """kind in {'btd', 'btf', 'bthd', 'logits', 'ecf', 'moe_route',
    'carry'}: see ``launch/sharding.py``."""
    if _ACT_CONSTRAINT is None:
        return x
    return _ACT_CONSTRAINT(x, kind)


def shard_layer_params(tree):
    """A layer's slice of the stacked weights (or the weights outside the
    stacks) as the layer computes with them: on a mesh, each split
    weight gathered whole inside the loop, so the peak holds one layer's
    gathered weights, not every layer's."""
    if _LAYER_PARAM_CONSTRAINT is None:
        return tree
    return _LAYER_PARAM_CONSTRAINT(tree)

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms: statistics in f32, cast back to the input's type, then the weight
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def norm_params(d: int, kind: str, dtype: torch.dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T) int. Rotates the two
    halves of each head in f32 and casts back to x's type."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def causal_mask(t: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(t, t) bool, True = attendable: query i sees key j <= i, and with
    a sliding window only the last ``window`` of them, i - window < j."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > i - window)
    return mask


def decode_mask(cache_len: int, pos: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(cache_len,) bool for one query at absolute position ``pos``,
    windowed as ``causal_mask``."""
    j = torch.arange(cache_len, device=device)
    mask = j <= pos
    if window is not None:
        mask = mask & (j > pos - window)
    return mask


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V), targets (...) int. In
    f32 (f64 logits stay f64)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 axis) -> torch.Tensor:
    """``cross_entropy`` of logits split over ``axis``'s ranks on the vocab
    (this rank's (..., V / M) block, rows rank * V / M onward): the max
    over the ranks, then the sum of exp and the gold logit (from the rank
    that owns the target; 0 elsewhere), each summed over the ranks. Every
    rank returns the same loss; its gradient reaches this rank's block
    only. In f32, as ``cross_entropy`` (f64 logits stay f64)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    v = logits.shape[-1]
    lo = axis.rank * v
    with torch.no_grad():
        m = axis.all_reduce(torch.amax(logits, dim=-1), "max")
    total = axis.reduce_out(torch.sum(torch.exp(logits - m[..., None]),
                                      dim=-1))
    t = targets.long() - lo
    mine = (t >= 0) & (t < v)
    gold = torch.gather(logits, -1, t.clamp(0, v - 1)[..., None])[..., 0]
    gold = axis.reduce_out(torch.where(mine, gold, torch.zeros_like(gold)))
    return torch.mean(m + torch.log(total) - gold)
