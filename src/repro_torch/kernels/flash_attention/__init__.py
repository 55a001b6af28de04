from .ops import flash_attention, route, tma_strides
from .ref import (
    BF16_MAX_ERR,
    BF16_MEAN_VS_LIBRARY,
    BF16_ROW_ERR,
    bf16_attention_check,
    flash_attention_ref,
    gqa_flash_attention_ref,
)
