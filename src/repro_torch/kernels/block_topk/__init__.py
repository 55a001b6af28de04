from .ops import diff_topk_payload
from .ref import diff_topk_payload_ref, to_tiles
