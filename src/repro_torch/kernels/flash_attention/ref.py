"""Plain PyTorch versions of causal attention, optionally over a sliding
window: the reference's oracle ``flash_attention_ref`` over folded
(B*H, T, hd) inputs, and the same function over the wrapper's
(B, T, H, hd) layout with grouped KV heads. Both materialise the (T, T)
scores in f32; set
``torch.backends.cuda.matmul.allow_tf32 = False`` (its default) for full
f32 products on a card."""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int | None = None) -> torch.Tensor:
    """Dense causal softmax attention over (BH, T, hd), scores in f32,
    masked scores -1e30, the result in q's type. With a ``window``,
    query i attends to keys j with i - window < j <= i."""
    _, t, hd = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (hd ** 0.5)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    if window is not None:
        mask = torch.triu(mask, diagonal=1 - window)
    s = torch.where(mask[None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def gqa_flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            window: int | None = None) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, T, KV, hd) with KV dividing H: head h
    reads KV head h // (H / KV), over ``window`` as
    ``flash_attention_ref``. Returns (B, T, H, hd) in q's type."""
    b, t, h, hd = q.shape
    n_rep = h // k.shape[2]

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, hd)

    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    out = flash_attention_ref(fold(q), fold(k), fold(v), window)
    return out.reshape(b, h, t, hd).transpose(1, 2)


# The bf16 kernel rounds P to bf16 before P V (as every tensor-core flash
# attention does) and sums in another order than the plain version, so an
# output near 0 can differ from the plain version's by more than one bf16
# step of itself. It is held instead, head by head, to the plain version
# computed in f32 on the same bf16 inputs and not rounded (the oracle):
# its largest error within BF16_MAX_ERR of the head's largest |oracle|
# (two bf16 steps at the top of the range), its mean error within
# BF16_MEAN_VS_LIBRARY times that of a library kernel on the same inputs,
# and each row's largest error within BF16_ROW_ERR of that row's largest
# |oracle| (four bf16 steps; a row's scale is taken as at least
# BF16_ROW_FLOOR of the head's), so that one wrong row, whose outputs may
# be far below the head's largest, fails as well.
BF16_MAX_ERR = 2 * 2.0 ** -8
BF16_MEAN_VS_LIBRARY = 1.5
BF16_ROW_ERR = 4 * 2.0 ** -8
BF16_ROW_FLOOR = 2.0 ** -8


def bf16_attention_check(got: torch.Tensor, oracle: torch.Tensor,
                         library: torch.Tensor) -> dict:
    """One head's bf16 output ``got`` (T, hd) against the f32 ``oracle``,
    beside a library kernel's output ``library`` (all of one shape).
    Returns the errors, their limits and ``ok``; ``row_err`` is the worst
    row's largest error over its scale."""
    got, oracle, library = (x.float() for x in (got, oracle, library))
    head = float(oracle.abs().max())
    max_limit = BF16_MAX_ERR * head
    err = (got - oracle).abs()
    row_scale = oracle.abs().amax(-1).clamp(min=BF16_ROW_FLOOR * head)
    row_err = float((err.amax(-1) / row_scale).max()) if head > 0 else 0.0
    library_mean = float((library - oracle).abs().mean())
    out = {"max_err": float(err.max()), "max_limit": max_limit,
           "mean_err": float(err.mean()), "library_mean_err": library_mean,
           "mean_limit": BF16_MEAN_VS_LIBRARY * library_mean,
           "row_err": row_err, "row_limit": BF16_ROW_ERR}
    out["ok"] = (out["max_err"] <= max_limit
                 and out["mean_err"] <= out["mean_limit"]
                 and row_err <= BF16_ROW_ERR)
    return out
