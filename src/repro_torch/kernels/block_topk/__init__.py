from .ops import block_topk, block_topk_payload, diff_topk_payload
from .ref import (
    block_topk_payload_ref,
    block_topk_ref,
    diff_topk_payload_ref,
    from_tiles,
    to_tiles,
)
