"""Plain PyTorch versions of causal attention: the reference's oracle
``flash_attention_ref`` over folded (B*H, T, hd) inputs, and the same
function over the wrapper's (B, T, H, hd) layout with grouped KV heads.
Both materialise the (T, T) scores in f32; set
``torch.backends.cuda.matmul.allow_tf32 = False`` (its default) for full
f32 products on a card."""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Dense causal softmax attention over (BH, T, hd), scores in f32,
    masked scores -1e30, the result in q's type."""
    _, t, hd = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (hd ** 0.5)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    s = torch.where(mask[None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def gqa_flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, T, KV, hd) with KV dividing H: head h
    reads KV head h // (H / KV). Returns (B, T, H, hd) in q's type."""
    b, t, h, hd = q.shape
    n_rep = h // k.shape[2]

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, hd)

    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    out = flash_attention_ref(fold(q), fold(k), fold(v))
    return out.reshape(b, h, t, hd).transpose(1, 2)
