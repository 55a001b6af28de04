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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import dense_init, shard_act
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


def _project(p: dict, u: torch.Tensor):
    """(B, C, Delta, A) of the conv's activations u: B and C in f32, Delta
    = softplus of the rank-1 projection plus dt_bias, A = -exp(a_log)."""
    bc = u @ p["wbc"]
    b_in, c_in = bc.float().chunk(2, dim=-1)
    dt = F.softplus((u @ p["wdt"]).float() + p["dt_bias"])
    return b_in, c_in, dt, -torch.exp(p["a_log"])


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). The causal depthwise conv is the
    reference's Python ``sum`` of d_conv shifted products, in its order
    and in the model dtype."""
    m = cfg.mamba
    t = x.shape[1]
    u, z = (x @ p["win"]).chunk(2, dim=-1)                   # (B,T,Di) each
    u_pad = F.pad(u, (0, 0, m.d_conv - 1, 0))
    conv = sum(u_pad[:, i:i + t] * p["conv"][i] for i in range(m.d_conv))
    u = shard_act(F.silu(conv + p["conv_b"]), "btf")
    b_in, c_in, dt, a = _project(p, u)
    y = _ssm_scan(u.float(), dt, b_in, c_in, a)
    y = y + p["d_skip"] * u.float()
    return shard_act((y.to(x.dtype) * F.silu(z)) @ p["wout"], "btd")


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
    are written into ``cache`` in place, which is returned."""
    u, z = (x @ p["win"]).chunk(2, dim=-1)                   # (B,1,Di)
    window = torch.cat([cache["conv"], u], dim=1)            # (B,d_conv,Di)
    conv = torch.einsum("bkd,kd->bd", window, p["conv"])[:, None]
    u_act = F.silu(conv + p["conv_b"])
    b_in, c_in, dt, a = _project(p, u_act)
    decay = torch.exp(dt[:, 0, :, None] * a[None])           # (B,Di,S)
    inc = (dt[:, 0] * u_act[:, 0].float())[..., None] * b_in[:, 0, None, :]
    ssm = cache["ssm"] * decay + inc
    y = torch.einsum("bds,bs->bd", ssm, c_in[:, 0])[:, None]
    y = y + p["d_skip"] * u_act.float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["wout"]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return y, cache
