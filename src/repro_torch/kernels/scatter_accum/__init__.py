from .ops import block_scatter_accumulate, plan, scatter_accumulate
from .ref import block_scatter_accumulate_ref, scatter_accumulate_ref
