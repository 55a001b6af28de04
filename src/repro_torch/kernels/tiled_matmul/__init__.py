from .ops import plan, powersgd_rank_r, subspace_iteration, tiled_matmul
from .ref import subspace_iteration_ref, tiled_matmul_ref
