from .ops import flash_attention
from .ref import flash_attention_ref, gqa_flash_attention_ref
