"""xLSTM blocks (Beck et al., arXiv:2405.04517), mLSTM and sLSTM, the
counterparts of ``src/repro/models/xlstm.py``.

mLSTM: matrix-memory LSTM with exponential gating; per head
    C_t = f_t C_{t-1} + i_t v_t k_t^T        (hd x hd matrix memory)
    n_t = f_t n_{t-1} + i_t k_t
    y_t = C_t q_t / max(|n_t^T q_t|, exp(-m_t))   (stabilized)
The prefill takes the chunkwise-parallel form: attention-like within
chunks of ``chunk`` steps, a carried (C, n, m) state across them, the
stabilizer m tracked in log space. Decode is O(1) in the state.

sLSTM: scalar-memory LSTM whose gates read h_{t-1}, so inherently
sequential: a loop over the steps, one per ``slstm_every`` blocks.

Both decodes write the new state into the cache in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init
from .config import ModelConfig

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.tdtype
    return {
        "wq": dense_init(gen, d, d, dt),
        "wk": dense_init(gen, d, d, dt),
        "wv": dense_init(gen, d, d, dt),
        "wif": dense_init(gen, d, 2 * h, dt),      # input and forget gates
        "wo_gate": dense_init(gen, d, d, dt),
        "wout": dense_init(gen, d, d, dt,
                           scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _mlstm_chunk_scan(q, k, v, logf, logi, chunk: int) -> torch.Tensor:
    """q, k, v: (B, H, T, hd); logf, logi: (B, H, T), all f32, T a
    multiple of ``chunk``. Returns y (B, H, T, hd).

    Within a chunk the log weight of position j's contribution to i is
    F_i - F_j + logi_j for j <= i (F the chunk's cumulative log forget,
    -inf above the diagonal); the carried state adds m + F_i. Each row
    is scaled by its running max (floored at -1e30), and the state
    carries to the next chunk under its own max."""
    b, h, t, hd = q.shape
    scale = math.sqrt(float(hd))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    c_state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
    n_state = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    m_state = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    ys = []
    for s in range(0, t, chunk):
        qi, ki, vi = (x[:, :, s:s + chunk] for x in (q, k, v))
        icu = logi[:, :, s:s + chunk]
        fcu = torch.cumsum(logf[:, :, s:s + chunk], dim=-1)
        fs = fcu[..., -1]

        intra = fcu[..., :, None] - fcu[..., None, :] + icu[..., None, :]
        intra = torch.where(tri, intra, -torch.inf)
        inter_log = fcu + m_state[..., None]                    # (B,H,L)
        m_new = torch.maximum(intra.amax(dim=-1), inter_log)
        m_new = torch.clamp_min(m_new, -1e30)
        w_intra = torch.exp(intra - m_new[..., None])           # (B,H,L,L)
        w_inter = torch.exp(inter_log - m_new)                  # (B,H,L)

        scores = (qi @ ki.transpose(-1, -2)) / scale
        weighted = scores * w_intra
        y_intra = weighted @ vi
        y_inter = w_inter[..., None] * (qi @ c_state) / scale
        qn_intra = weighted.sum(dim=-1)
        qn_inter = w_inter * torch.einsum("bhid,bhd->bhi", qi, n_state) / scale
        denom = torch.maximum(torch.abs(qn_intra + qn_inter), torch.exp(-m_new))
        ys.append((y_intra + y_inter) / denom[..., None])

        carry_log = fs[..., None] - fcu + icu                   # (B,H,L)
        m_carry = torch.maximum(fs + m_state, carry_log.amax(dim=-1))
        w_carry = torch.exp(carry_log - m_carry[..., None])
        decay = torch.exp(fs + m_state - m_carry)
        kw = ki * w_carry[..., None]
        c_state = decay[..., None, None] * c_state + kw.transpose(-1, -2) @ vi
        n_state = decay[..., None] * n_state + kw.sum(dim=-2)
        m_state = m_carry
    return torch.cat(ys, dim=2)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, d) -> (B, H, T, d / H) in f32."""
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2).float()


def _gates(p: dict, x: torch.Tensor, h: int):
    """(log input gate, log forget gate), f32. ``wif``'s 2H outputs are
    interleaved per head: (i_0, f_0, i_1, f_1, ...)."""
    g = (x @ p["wif"]).float().reshape(*x.shape[:-1], h, 2)
    return g[..., 0], F.logsigmoid(g[..., 1])


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). T is zero-padded to a multiple of the
    chunk (min(chunk, T)); the output gate reads the unpadded x."""
    b, t, d = x.shape
    h = cfg.n_heads
    chunk = min(cfg.xlstm.chunk, t)
    pad = (-t) % chunk
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    q, k, v = (_heads(xp @ p[w], h) for w in ("wq", "wk", "wv"))
    logi, logf = (g.transpose(1, 2) for g in _gates(p, xp, h))  # (B,H,T)
    y = _mlstm_chunk_scan(q, k, v, logf, logi, chunk)
    y = y.transpose(1, 2).reshape(b, t + pad, d)[:, :t]
    o = torch.sigmoid(x @ p["wo_gate"])
    return (y.to(x.dtype) * o) @ p["wout"]


def mlstm_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    h = cfg.n_heads
    hd = cfg.d_model // h
    f32 = torch.float32
    return {"c": torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, d). One step of the recurrence; (C, n, m) are written
    into ``cache`` in place, which is returned."""
    b, _, d = x.shape
    h = cfg.n_heads
    hd = d // h
    scale = math.sqrt(float(hd))
    q, k, v = ((x @ p[w]).reshape(b, h, hd).float()
               for w in ("wq", "wk", "wv"))
    logi, logf = _gates(p, x[:, 0], h)                          # (B,H)
    m_new = torch.maximum(logf + cache["m"], logi)
    f_g = torch.exp(logf + cache["m"] - m_new)
    i_g = torch.exp(logi - m_new)
    c = (f_g[..., None, None] * cache["c"]
         + i_g[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = f_g[..., None] * cache["n"] + i_g[..., None] * k
    qn = torch.einsum("bhd,bhd->bh", q, n) / scale
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    y = torch.einsum("bhd,bhde->bhe", q, c) / scale / denom[..., None]
    o = torch.sigmoid(x @ p["wo_gate"])
    out = (y.reshape(b, 1, d).to(x.dtype) * o) @ p["wout"]
    for name, val in (("c", c), ("n", n), ("m", m_new)):
        cache[name].copy_(val)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.tdtype
    return {
        "wx": dense_init(gen, d, 4 * d, dt),       # i, f, z, o pre-activations
        "wr": dense_init(gen, d, 4 * d, dt, scale=0.5),   # recurrent
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
        "wout": dense_init(gen, d, d, dt,
                           scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _slstm_cell(c, n, m, pre):
    """One step from (c, n, m) and the step's f32 pre-activations (B, 4d):
    returns (c, n, h, m)."""
    zi, zf, zz, zo = pre.chunk(4, dim=-1)
    logf = F.logsigmoid(zf)
    m_new = torch.maximum(logf + m, zi)
    i_g = torch.exp(zi - m_new)
    f_g = torch.exp(logf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(zz)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(zo) * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d), one step at a time; h is cast to the
    model dtype before the recurrent product at every step."""
    b, t, d = x.shape
    xs = (x @ p["wx"]).float() + p["b"]
    z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    c, n, h = z, z, z
    m = torch.full((b, d), -1e30, dtype=torch.float32, device=x.device)
    hs = []
    for i in range(t):
        pre = xs[:, i] + (h.to(x.dtype) @ p["wr"]).float()
        c, n, h, m = _slstm_cell(c, n, m, pre)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return y @ p["wout"]


def slstm_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, d), -1e30, dtype=torch.float32,
                            device=device)}


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, d). One step; (c, n, h, m) are written into ``cache`` in
    place, which is returned."""
    pre = ((x[:, 0] @ p["wx"]).float() + p["b"]
           + (cache["h"].to(x.dtype) @ p["wr"]).float())
    c, n, h, m = _slstm_cell(cache["c"], cache["n"], cache["m"], pre)
    y = (h.to(x.dtype) @ p["wout"])[:, None]
    for name, val in (("c", c), ("n", n), ("h", h), ("m", m)):
        cache[name].copy_(val)
    return y, cache
