from .ops import DEFAULT_BLOCK, hess_update, resolve_block
from .ref import hess_update_ref


def analysis_targets():
    """The reference's config for the analysis sweep: the fused
    H += alpha S with ||H - D||_F at 512 x 512, block 128."""
    import torch

    from ...analysis.trace_utils import call_kernel, trace

    def m(seed):
        return torch.randn((512, 512),
                           generator=torch.Generator().manual_seed(seed))

    return [
        {
            "name": "hess_update[512x512,b=128]",
            "trace": lambda: trace(lambda h, d, s: call_kernel(
                "hess_update", h, d, s, 0.5, block=128), m(0), m(1), m(2)),
            "context": {"block": 128},
        },
    ]
