from .ops import (
    block_scatter_accumulate,
    plan,
    resolve_plan,
    scatter_accumulate,
    silo_chunk_for,
    streamed_scatter_accumulate,
    streamed_slab_update,
)
from .ref import block_scatter_accumulate_ref, scatter_accumulate_ref


def analysis_targets():
    """Representative configs for the analysis sweep, the reference's six
    names: ``scatter_accumulate`` on one 512 x 512 accumulator, at
    4096 x 4096 (where the reference tiles; K2 is linear in d), with the
    fused symmetric mirror; the streamed slab update (one slab and the
    running accumulator); one rank's row window of the sharded sum; and
    the block-sparse sum. Each kernel call is one ``kernel:`` record the
    ``smem-budget`` rule prices."""
    import torch

    from ...analysis.trace_utils import call_kernel, trace
    from .sharded import row_window_scatter

    def pair(n, k, cells):
        g = torch.Generator().manual_seed(n * k)
        v = torch.randn((n, k), generator=g)
        i = torch.randint(-1, cells, (n, k), generator=g, dtype=torch.int32)
        return v, i

    def lower(n, k, d):
        g = torch.Generator().manual_seed(k)
        r = torch.randint(0, d, (n, k), generator=g)
        c = torch.randint(0, d, (n, k), generator=g)
        i = (torch.maximum(r, c) * d + torch.minimum(r, c)).to(torch.int32)
        return torch.randn((n, k), generator=g), i

    def blocks():
        g = torch.Generator().manual_seed(3)
        return (torch.randn((3, 16, 64), generator=g),
                torch.randint(-1, 128 * 128, (3, 16, 64), generator=g,
                              dtype=torch.int32))

    return [
        {
            "name": "scatter_accumulate[512x512,single-block]",
            "trace": lambda: trace(lambda v, i: call_kernel(
                "scatter_accumulate", v, i, (512, 512)),
                *pair(4, 512, 512 * 512)),
            "context": {},
        },
        {
            "name": "scatter_accumulate[4096x4096,tiled]",
            "trace": lambda: trace(lambda v, i: call_kernel(
                "scatter_accumulate", v, i, (4096, 4096)),
                *pair(4, 2048, 4096 * 4096)),
            "context": {},
        },
        {
            "name": "scatter_accumulate[1024x1024,symmetric-fused]",
            "trace": lambda: trace(lambda v, i: call_kernel(
                "scatter_accumulate", v, i, (1024, 1024), symmetric=True),
                *lower(4, 512, 1024)),
            "context": {},
        },
        {
            "name": "streamed_slab_update[4096x4096,tiled,slab=4]",
            "trace": lambda: trace(
                lambda a, v, i: streamed_slab_update(a, v, i, (4096, 4096)),
                torch.zeros((4096, 4096)), *pair(4, 2048, 4096 * 4096)),
            "context": {},
        },
        {
            "name": "row_window_scatter[1024-row window of 4096x4096]",
            "trace": lambda: trace(lambda v, i: row_window_scatter(
                v, i, (4096, 4096), 1024, 1024),
                *pair(4, 2048, 4096 * 4096)),
            "context": {},
        },
        {
            "name": "block_scatter_accumulate[4x4 grid,b=128]",
            "trace": lambda: trace(lambda v, i: call_kernel(
                "block_scatter_accumulate", v, i, (4, 4), 128), *blocks()),
            "context": {"block": 128},
        },
    ]
