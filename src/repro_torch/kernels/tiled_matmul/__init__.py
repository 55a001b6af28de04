from .ops import (
    plan,
    powersgd_rank_r,
    resolve_plan,
    subspace_iteration,
    tiled_matmul,
    with_chunks,
)
from .ref import powersgd_rank_r_ref, subspace_iteration_ref, tiled_matmul_ref


def analysis_targets():
    """The reference's configs for the analysis sweep: the f32 matmul and
    the PowerSGD subspace iteration built on it (four products, each a
    ``kernel:`` record)."""
    import torch

    from ...analysis.trace_utils import call_kernel, trace

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn((384, 256), generator=g), torch.randn((256, 384),
                                                             generator=g)
    m = torch.randn((512, 512), generator=g)
    return [
        {
            "name": "tiled_matmul[384x256 @ 256x384]",
            "trace": lambda: trace(
                lambda x, y: call_kernel("tiled_matmul", x, y), a, b),
            "context": {},
        },
        {
            "name": "powersgd_rank_r[512x512,r=2]",
            "trace": lambda: trace(lambda x: powersgd_rank_r(x, 2), m),
            "context": {},
        },
    ]
