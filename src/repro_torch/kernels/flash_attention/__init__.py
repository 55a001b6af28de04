from .ops import DEFAULT_TILES, flash_attention, resolve_tiles, route, tma_strides
from .ref import (
    BF16_MAX_ERR,
    BF16_MEAN_VS_LIBRARY,
    BF16_ROW_ERR,
    bf16_attention_check,
    flash_attention_ref,
    gqa_flash_attention_ref,
)


def analysis_targets():
    """The reference's config for the analysis sweep: causal attention at
    T = 384 over (1, 384, 2, 64) f32 heads, with the port's default tiles
    (bq = bk = 128, the reference's too) on the FFMA route."""
    import torch

    from ...analysis.trace_utils import call_kernel, trace

    q = torch.randn((1, 384, 2, 64), generator=torch.Generator().manual_seed(0))
    return [
        {
            "name": "flash_attention[T=384,bq=bk=128]",
            "trace": lambda: trace(lambda a, b, c: call_kernel(
                "flash_attention", a, b, c, bq=128, bk=128), q, q, q),
            "context": {},
        },
    ]
