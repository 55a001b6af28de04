"""Dense feed-forward block (swiglu / gelu), the counterpart of the dense
MLP of ``src/repro/models/mlp.py``. MoE waits for ROADMAP Queue A
item 12."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init
from .config import ModelConfig


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> dict:
    d, ff, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.tdtype
    scale_o = 1.0 / (2 * cfg.n_layers) ** 0.5
    if cfg.mlp_type == "swiglu":
        return {"wi": dense_init(gen, d, ff, dt), "wg": dense_init(gen, d, ff, dt),
                "wo": dense_init(gen, ff, d, dt, scale=scale_o)}
    return {"wi": dense_init(gen, d, ff, dt),
            "wo": dense_init(gen, ff, d, dt, scale=scale_o)}


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return (h @ p["wo"]).to(x.dtype)
