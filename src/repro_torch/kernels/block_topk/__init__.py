from .ops import block_topk, block_topk_payload, diff_topk_payload
from .ref import (
    block_topk_payload_ref,
    block_topk_ref,
    diff_topk_payload_ref,
    from_tiles,
    to_tiles,
)


def analysis_targets():
    """Representative configs for the analysis sweep
    (``repro_torch.analysis``), the reference's three: name -> a run
    under the recorder + rule context. Each call is one ``kernel:`` record
    whose launch the ``smem-budget`` rule prices; the fused diff -> top-k
    target also carries ``dense_forbidden``, so ``no-dense-roundtrip``
    shows the dense (d, d) difference is never built outside the
    kernel."""
    import torch

    from ...analysis.trace_utils import call_kernel, trace

    def x():
        return torch.randn((512, 512), generator=torch.Generator().manual_seed(0))

    return [
        {
            "name": "block_topk[512x512,k=32,b=128]",
            "trace": lambda: trace(lambda m: call_kernel(
                "block_topk", m, 32, 128), x()),
            "context": {"block": 128},
        },
        {
            "name": "block_topk_payload[512x512,k=32,b=128]",
            "trace": lambda: trace(lambda m: call_kernel(
                "block_topk_payload", m, 32, 128), x()),
            "context": {"block": 128},
        },
        {
            "name": "diff_topk_payload[512x512,k=32,b=128,fused]",
            "trace": lambda: trace(lambda a, b: call_kernel(
                "diff_topk_payload", a, b, 32, 128), x()[None], x()),
            "context": {"block": 128, "dense_forbidden": (512, 512)},
        },
    ]
