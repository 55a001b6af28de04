"""Feed-forward blocks: the dense MLP (swiglu / gelu) and the
capacity-based MoE, the counterparts of ``src/repro/models/mlp.py``.

The MoE routes tokens in groups of ``group_size``: each expert takes at
most C = ceil(top_k * group * capacity_factor / E) of a group's token
slots, slot 0 of every token before any slot 1, and the slots beyond C
are dropped. The reference builds ``dispatch`` and ``combine`` (G, E, C)
as sums of (k * G, E, C) one-hot products; the port writes them by
index, one cell per kept (token, slot), which is the same tensor bit for
bit (a token's top-k experts are distinct, so a (g, e) cell takes at
most one slot). The dispatch and combine products stay einsums, as the
reference computes them. A Switch load-balance loss rides along.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> dict:
    d, ff, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.tdtype
    scale_o = 1.0 / (2 * cfg.n_layers) ** 0.5
    if cfg.mlp_type == "swiglu":
        return {"wi": dense_init(gen, d, ff, dt), "wg": dense_init(gen, d, ff, dt),
                "wo": dense_init(gen, ff, d, dt, scale=scale_o)}
    return {"wi": dense_init(gen, d, ff, dt),
            "wo": dense_init(gen, ff, d, dt, scale=scale_o)}


def _act(h: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """swiglu's silu(g) * h, or gelu(h) (jax.nn.gelu's default is the
    tanh approximation) where there is no gate."""
    if g is not None:
        return F.silu(g) * h
    return F.gelu(h, approximate="tanh")


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = x @ p["wg"] if cfg.mlp_type == "swiglu" else None
    return (_act(x @ p["wi"], gate) @ p["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _experts(gen: torch.Generator, e: int, d_in: int, d_out: int,
             dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """(e, d_in, d_out) expert weights, drawn expert by expert into one
    preallocated tensor (a stack of drawn copies would hold them twice)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(e):
        out[i] = dense_init(gen, d_in, d_out, dtype, scale)
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (an f32 leaf in any model dtype, as the reference's) and
    the experts' weights stacked on axis 0."""
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.moe.num_experts, cfg.tdtype
    p = {"router": dense_init(gen, d, e, torch.float32),
         "wi": _experts(gen, e, d, ff, dt),
         "wo": _experts(gen, e, ff, d, dt, 1.0 / (2 * cfg.n_layers) ** 0.5)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = _experts(gen, e, d, ff, dt)
    return p


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per expert in a group of ``group`` tokens (Python float
    arithmetic, as the reference's)."""
    moe = cfg.moe
    return max(1, math.ceil(moe.top_k * group * moe.capacity_factor
                            / moe.num_experts))


def top_k_lower_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, ties to the lower index (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    ids = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, ids), ids


def _route(router_logits: torch.Tensor, cfg: ModelConfig):
    """router_logits: (..., G, E). Returns dispatch (..., G, E, C) of 0 and
    1, combine (..., G, E, C) and the aux loss (...), all f32, each group
    routed on its own as the reference's ``_route``."""
    lead, (g, e) = router_logits.shape[:-2], router_logits.shape[-2:]
    k, c = cfg.moe.top_k, capacity(cfg, g)
    probs = torch.softmax(router_logits.reshape(-1, g, e).float(), dim=-1)
    n = probs.shape[0]
    gate_vals, gate_ids = top_k_lower_index(probs, k)             # (N, G, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # slot-major priority: slot 0 of every token first; a slot's place in
    # its expert is the number of earlier (slot, token) pairs that chose it
    masks = F.one_hot(gate_ids, e)                                # (N, G, k, E)
    slot_ids = gate_ids.transpose(1, 2).reshape(n, k * g)         # (N, k*G)
    flat = masks.transpose(1, 2).reshape(n, k * g, e)
    pos = torch.gather(torch.cumsum(flat, dim=1) - flat, 2,
                       slot_ids[..., None])[..., 0]               # (N, k*G)
    keep = pos < c
    vals = gate_vals.transpose(1, 2).reshape(n, k * g)
    # one cell per (group, token, slot): a dropped slot writes 0 into its
    # own (g, e) cell, which no other slot shares
    ni = torch.arange(n, device=probs.device)[:, None].expand(n, k * g)
    gi = torch.arange(g, device=probs.device).repeat(k)[None].expand(n, k * g)
    cell = (ni, gi, slot_ids, pos.clamp(max=c - 1))
    zeros = torch.zeros((n, g, e, c), dtype=torch.float32, device=probs.device)
    dispatch = zeros.index_put(cell, keep.float())
    combine = zeros.index_put(cell, vals * keep)

    # load-balance auxiliary loss (Switch eq. 4), per group
    frac_tokens = torch.mean(torch.sum(masks.float(), dim=2), dim=1)  # (N, E)
    frac_probs = torch.mean(probs, dim=1)
    aux = e * torch.sum(frac_tokens * frac_probs, dim=-1)
    return (dispatch.reshape(lead + (g, e, c)),
            combine.reshape(lead + (g, e, c)), aux.reshape(lead))


def group_tokens(x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (groups (NG, G, d), the number of real tokens): the
    tokens in groups of ``group_size``, the last one zero-padded."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    gsz = min(cfg.moe.group_size, n_tok)
    pad = (-n_tok) % gsz
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    return tokens.reshape(-1, gsz, d), n_tok


def route_groups(p: dict, groups: torch.Tensor, cfg: ModelConfig):
    """The router: f32 logits of the groups, then ``_route``."""
    logits = torch.einsum("ngd,de->nge", groups.float(), p["router"])
    return _route(logits, cfg)


def dispatch_tokens(dispatch: torch.Tensor,
                    groups: torch.Tensor) -> torch.Tensor:
    """Each expert's slots (NG, E, C, d), ``dispatch`` cast to the
    activations' type."""
    return torch.einsum("ngec,ngd->necd", dispatch.to(groups.dtype), groups)


def run_experts(p: dict, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The experts' MLPs on their slots: (NG, E, C, d) -> (NG, E, C, d)."""
    gate = (torch.einsum("necd,edf->necf", xin, p["wg"])
            if cfg.mlp_type == "swiglu" else None)
    h = _act(torch.einsum("necd,edf->necf", xin, p["wi"]), gate)
    del gate
    return torch.einsum("necf,efd->necd", h, p["wo"])


def combine_tokens(combine: torch.Tensor, xout: torch.Tensor) -> torch.Tensor:
    """The experts' outputs weighted back into the groups' tokens
    (NG, G, d), ``combine`` cast to the activations' type."""
    return torch.einsum("ngec,necd->ngd", combine.to(xout.dtype), xout)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (y, aux loss). Tokens route in groups of
    ``group_size`` (the last one zero-padded; pads take part in the
    routing and the loss, as in the reference); the router's logits are
    f32, dispatch and combine are cast to the activations' type."""
    groups, n_tok = group_tokens(x, cfg)
    dispatch, combine, aux = route_groups(p, groups, cfg)
    xin = dispatch_tokens(dispatch, groups)
    del dispatch, groups
    xout = run_experts(p, xin, cfg)
    del xin
    y = combine_tokens(combine, xout).reshape(-1, x.shape[-1])[:n_tok]
    return y.reshape(x.shape), torch.mean(aux)
