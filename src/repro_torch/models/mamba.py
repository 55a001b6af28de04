"""Mamba (selective SSM) block of the jamba hybrid stack, the counterpart
of ``src/repro/models/mamba.py``.

Mamba-1: in_proj -> (u, z); a short causal depthwise conv; data-dependent
(Delta, B, C) projections; the diagonal selective SSM

    h_t = exp(Delta_t A) h_{t-1} + Delta_t B_t u_t
    y_t = C_t . h_t + D u_t

The prefill runs the recurrence as the reference does: chunks of
``SSM_CHUNK`` steps in order, each carrying the (B, Di, S) state into
its first increment, with a log-depth scan inside a chunk (the reference
takes ``jax.lax.associative_scan``; here a Hillis-Steele scan in plain
PyTorch, whose tree differs, so the two agree to rounding, not bit for
bit). Decode keeps (conv window, ssm state) as the layer's cache and
updates it in place: O(1) a token.

Over a "model" axis (``common.model_axis()``) each rank runs the conv
and the scan on its Di / M channels, the reference's rules' split of
``conv``, ``wout`` and the decode caches (``mamba_forward``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import dense_init, model_axis, shard_act
from .config import ModelConfig


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's leaves and laws: A's log S4D-real (1..S on every
    channel), dt_bias the inverse softplus of exp(U(log 1e-3, log 1e-1))
    and the skip D ones, all f32 in any model dtype; wdt a rank-1 Delta
    projection; wout scaled by 1 / sqrt(2 n_layers)."""
    m, d, dt, dev = cfg.mamba, cfg.d_model, cfg.tdtype, gen.device
    di = m.expand * d
    win = dense_init(gen, d, 2 * di, dt)
    conv = (torch.randn((m.d_conv, di), generator=gen, device=dev)
            / m.d_conv).to(dt)
    wbc = dense_init(gen, di, 2 * m.d_state, dt)
    wdt = dense_init(gen, di, 1, dt)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((di,), generator=gen, device=dev) * (hi - lo) + lo
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32,
                     device=dev)[None].expand(di, m.d_state)
    return {
        "win": win,
        "conv": conv,
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "wbc": wbc,
        "wdt": wdt,
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "wout": dense_init(gen, di, d, dt,
                           scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


SSM_CHUNK = 256


def _scan(decay: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = decay_t h_{t-1} + inc_t along axis 1 (from
    h_{-1} = 0) in log2(T) steps: at offset o each step folds h_{t-o}
    into h_t, reading the previous step's buffers (Hillis-Steele).

    Where autograd records (grad enabled and an input that requires a
    gradient) each step is built out of place, ``torch.cat`` of the
    prefix and the folded tail, since autograd cannot differentiate a
    write through ``out=``; the products are the same, so both ways give
    the same bits."""
    t = inc.shape[1]
    graph = torch.is_grad_enabled() and (inc.requires_grad
                                         or decay.requires_grad)
    off = 1
    while off < t:
        last = 2 * off >= t                # the last step needs no decay
        if graph:
            inc = torch.cat([inc[:, :off], torch.addcmul(
                inc[:, off:], inc[:, :-off], decay[:, off:])], dim=1)
            if not last:
                decay = torch.cat([decay[:, :off], torch.mul(
                    decay[:, :-off], decay[:, off:])], dim=1)
            off *= 2
            continue
        nxt = torch.empty_like(inc)
        nxt[:, :off] = inc[:, :off]
        torch.addcmul(inc[:, off:], inc[:, :-off], decay[:, off:],
                      out=nxt[:, off:])
        if not last:
            dnext = torch.empty_like(decay)
            dnext[:, :off] = decay[:, :off]
            torch.mul(decay[:, :-off], decay[:, off:], out=dnext[:, off:])
            decay = dnext
        inc = nxt
        off *= 2
    return inc


def _ssm_scan(u, dt, b, c, a, chunk: int = SSM_CHUNK) -> torch.Tensor:
    """u, dt: (B, T, Di); b, c: (B, T, S); a: (Di, S), all f32. Returns
    y (B, T, Di) with y_t = C_t . h_t.

    A scan over all of T would hold (B, T, Di, S) decays and increments
    (17 GB each in f32 for jamba's Di = 16,384 at T = 4,096), so for
    T > ``chunk`` the chunks run in order carrying the (B, Di, S) state,
    which is folded into each chunk's first increment; T is zero-padded
    to a multiple of ``chunk`` (a pad step has Delta = 0: decay 1, no
    increment). T <= ``chunk`` is one scan.

    Where autograd records, each chunk runs under ``checkpoint``: the
    backward keeps the carried states and one chunk's scan at a time
    (about 4.3 GB at jamba's width), not every chunk's (about 69 GB at
    T = 4,096). Without a gradient the chunks run directly."""
    graph = torch.is_grad_enabled() and any(
        x.requires_grad for x in (u, dt, b, c, a))

    def one(h0, ui, dti, bi, ci):
        decay = torch.exp(dti[..., None] * a[None, None])      # (B,L,Di,S)
        inc = (dti * ui)[..., None] * bi[:, :, None, :]
        if h0 is not None and graph:
            inc = torch.cat([inc[:, :1] + decay[:, :1] * h0[:, None],
                             inc[:, 1:]], dim=1)
        elif h0 is not None:
            inc[:, 0] += decay[:, 0] * h0
        h = _scan(decay, inc)
        return h[:, -1], torch.einsum("btds,bts->btd", h, ci)

    def run(*args):
        if graph:
            return checkpoint(one, *args, use_reentrant=False)
        return one(*args)

    bsz, t, di = u.shape
    if t <= chunk:
        return run(None, u, dt, b, c)[1]
    pad = (-t) % chunk
    if pad:
        u, dt, b, c = (F.pad(x, (0, 0, 0, pad)) for x in (u, dt, b, c))
    h = torch.zeros((bsz, di, b.shape[-1]), dtype=u.dtype, device=u.device)
    ys = []
    for s in range(0, t + pad, chunk):
        h, y = run(h, *(x[:, s:s + chunk] for x in (u, dt, b, c)))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t]


def _project(p: dict, u: torch.Tensor, tp=None):
    """(B, C, Delta, A) of the conv's activations u: B and C in f32, Delta
    = softplus of the rank-1 projection plus dt_bias, A = -exp(a_log).
    Over a "model" axis ``tp``, u is this rank's channels and ``p`` its
    rows of ``wbc``, ``wdt``, ``dt_bias`` and ``a_log`` (``_rank_weights``):
    the projections onto B, C and Delta's rank-1 term are partial sums
    over the channels, summed over the ranks in one ``reduce_out`` of
    (B, T, 2 S + 1), and their gradient, which each rank's channels give
    a part of, in the ``copy_in`` after it."""
    if tp is None:
        bc, low = u @ p["wbc"], u @ p["wdt"]
    else:
        both = tp.copy_in(tp.reduce_out(torch.cat(
            [u @ p["wbc"], u @ p["wdt"]], dim=-1)))
        bc, low = both[..., :-1], both[..., -1:]
    b_in, c_in = bc.float().chunk(2, dim=-1)
    dt = F.softplus(low.float() + p["dt_bias"])
    return b_in, c_in, dt, -torch.exp(p["a_log"])


def _in_proj(p: dict, x: torch.Tensor, tp):
    """(u, z) (B, T, Di each) of x, or over a "model" axis this rank's
    channels c_r of each. ``win``'s shard is a contiguous block of its
    2 Di columns (at M = 4, ranks 0-1 hold u's halves and 2-3 z's), so
    the product of the shard is gathered whole over the ranks on its last
    dim and narrowed to c_r of u and of z; the backward sums the ranks'
    gradients of it and keeps this rank's block (``gather_weight`` of an
    activation: 2 Di x B x T a layer, where gathering ``win`` would move
    d x 2 Di)."""
    if tp is None:
        return (x @ p["win"]).chunk(2, dim=-1)
    xw = tp.gather_weight(tp.copy_in(x) @ p["win"], x.dim() - 1)
    u, z = xw.chunk(2, dim=-1)
    return tp.part(u, -1), tp.part(z, -1)


def _rank_weights(p: dict, cfg: ModelConfig, tp) -> dict:
    """``p`` with the per-channel weights narrowed to this rank's channels
    c_r over the "model" axis ``tp`` (``conv``, ``wout`` and the caches
    are split on Di by the rules already): ``conv_b``, ``dt_bias``,
    ``d_skip`` and ``wdt``, whole over "model", and ``wbc`` and
    ``a_log``, split on their columns (B / C and the state) or whole
    where those do not divide, are taken whole (``weight_whole``) and
    narrowed to their rows c_r, so each gradient sums every rank's
    rows."""
    m = cfg.mamba
    di = m.expand * cfg.d_model
    out = dict(p)
    for name, dim, width in (("conv_b", 0, di), ("dt_bias", 0, di),
                             ("d_skip", 0, di), ("wdt", 1, 1),
                             ("wbc", 1, 2 * m.d_state),
                             ("a_log", 1, m.d_state)):
        out[name] = tp.part(tp.weight_whole(p[name], dim, width), 0)
    return out


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). The causal depthwise conv is the
    reference's Python ``sum`` of d_conv shifted products, in its order
    and in the model dtype. Over a "model" axis each rank runs the conv
    and the scan on its Di / M channels (``_in_proj``, ``_rank_weights``;
    the scan needs no collective), the projections onto B, C and Delta
    summed over the ranks (``_project``), and ``wout`` row-parallel
    before ``reduce_out``."""
    m = cfg.mamba
    t = x.shape[1]
    tp = model_axis()
    if tp is not None:
        p = _rank_weights(p, cfg, tp)
    u, z = _in_proj(p, x, tp)                                # (B,T,Di) each
    u_pad = F.pad(u, (0, 0, m.d_conv - 1, 0))
    conv = sum(u_pad[:, i:i + t] * p["conv"][i] for i in range(m.d_conv))
    u = shard_act(F.silu(conv + p["conv_b"]), "btf")
    b_in, c_in, dt, a = _project(p, u, tp)
    y = _ssm_scan(u.float(), dt, b_in, c_in, a)
    y = y + p["d_skip"] * u.float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["wout"]
    if tp is not None:
        y = tp.reduce_out(y)
    return shard_act(y, "btd")


def mamba_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """The last d_conv - 1 conv inputs in the model dtype and the SSM
    state in f32."""
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=cfg.tdtype,
                                device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                               device=device)}


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, d). One recurrence step; the new conv window and state
    are written into ``cache`` in place, which is returned. Over a
    "model" axis, on this rank's channels as ``mamba_forward``, with the
    cache's conv window and state of those channels (``cache_specs``)."""
    tp = model_axis()
    if tp is not None:
        p = _rank_weights(p, cfg, tp)
    u, z = _in_proj(p, x, tp)                                # (B,1,Di)
    window = torch.cat([cache["conv"], u], dim=1)            # (B,d_conv,Di)
    conv = torch.einsum("bkd,kd->bd", window, p["conv"])[:, None]
    u_act = F.silu(conv + p["conv_b"])
    b_in, c_in, dt, a = _project(p, u_act, tp)
    decay = torch.exp(dt[:, 0, :, None] * a[None])           # (B,Di,S)
    inc = (dt[:, 0] * u_act[:, 0].float())[..., None] * b_in[:, 0, None, :]
    ssm = cache["ssm"] * decay + inc
    y = torch.einsum("bds,bs->bd", ssm, c_in[:, 0])[:, None]
    y = y + p["d_skip"] * u_act.float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["wout"]
    if tp is not None:
        y = tp.reduce_out(y)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return y, cache
