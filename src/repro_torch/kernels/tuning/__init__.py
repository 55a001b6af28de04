"""Kernel autotuning: measured launch configs for the port's CUDA kernels,
counterpart of ``src/repro/kernels/tuning``.

``cache``  — the ``(op, d-bucket, k, n, dtype, device kind)`` ->
             ``KernelConfig`` store (in-memory + persisted JSON,
             ``$REPRO_TORCH_TUNING_CACHE`` pins one).
``tuner``  — candidate generation (shared-memory and register budget
             filtered), roofline pruning, CUDA-event measurement, winner
             recording.

The wrappers of K2/K3 (``scatter_accumulate``), K7 (``hess_update``), K8
(``tiled_matmul``) and K9 (``flash_attention``) resolve their launch
config as explicit argument > cached winner > untuned default, and an
empty cache leaves every launch as the untuned default. The top-k family
is not tuned (``tuner``'s docstring says why).
"""

from .cache import (
    CACHE_ENV,
    KernelConfig,
    TuningCache,
    bucket,
    cache_key,
    device_kind,
    get_cache,
    lookup,
    parse_key,
    record,
    set_cache,
)
from .tuner import (
    autotune_flash_attention,
    autotune_hess_update,
    autotune_scatter_accumulate,
    autotune_tiled_matmul,
    flash_candidates,
    hess_candidates,
    matmul_candidates,
    predict_matmul_us,
    predict_scatter_us,
    scatter_candidates,
    scatter_default,
    time_us,
)

__all__ = [
    "CACHE_ENV", "KernelConfig", "TuningCache", "bucket", "cache_key",
    "device_kind", "get_cache", "lookup", "parse_key", "record", "set_cache",
    "autotune_flash_attention", "autotune_hess_update",
    "autotune_scatter_accumulate", "autotune_tiled_matmul",
    "flash_candidates", "hess_candidates", "matmul_candidates",
    "predict_matmul_us", "predict_scatter_us", "scatter_candidates",
    "scatter_default", "time_us", "analysis_targets",
]

# the untuned defaults priced when the cache is empty: the reference's
# two scatter shapes (one block of 512 x 512, and 4096 x 4096)
_DEFAULT_SCATTER = (((512, 512), 512, 4), ((4096, 4096), 2048, 4))


def analysis_targets():
    """Every tuned config in the active cache as an analysis target whose
    kernel record the ``smem-budget`` rule prices — a tuned (or
    hand-pinned) pick over a block's shared memory or registers fails the
    sweep instead of failing its launch. A config is run at a small shape
    of its key's kind (the budget depends on the config, not on the
    shape); with an empty cache the untuned K2 plans at the reference's
    two shapes are traced instead, so the package always contributes."""
    import torch

    from ...analysis.trace_utils import call_kernel, trace

    targets = []

    def scatter_target(label, dims, k, n, dtype, cfg):
        fields = {} if cfg is None else dict(
            log_r=cfg.log_r, digit_bits=cfg.digit_bits, seg=cfg.seg)

        def run():
            g = torch.Generator().manual_seed(0)
            v = torch.randn((n, k), generator=g, dtype=dtype)
            i = torch.randint(-1, dims[0] * dims[1], (n, k), generator=g,
                              dtype=torch.int32)
            return trace(lambda vv, ii: call_kernel(
                "scatter_accumulate", vv, ii, dims, **fields), v, i)

        targets.append({"name": f"scatter_accumulate[{label}]",
                         "trace": run, "context": {}})

    for key, cfg in sorted(get_cache().entries().items()):
        op, dims, k, n, dtype, _dev = parse_key(key)
        tdtype = getattr(torch, dtype)
        label = f"tuned:{key}"
        if op == "scatter_accumulate" and dims:
            scatter_target(label, (64, 64), 32, 3, tdtype, cfg)
        elif op == "hess_update" and dims:
            block = cfg.block or 128

            def run(block=block, tdtype=tdtype):
                m = torch.ones((2, 96, 96), dtype=tdtype)
                return trace(lambda h, d, s: call_kernel(
                    "hess_update", h, d, s, 0.5, block=block), m, m, m)

            targets.append({"name": f"hess_update[{label}]", "trace": run,
                            "context": {"block": block}})
        elif op == "tiled_matmul" and dims:

            def run(cfg=cfg):
                a = torch.ones((256, 512))
                b = torch.ones((512, 4))
                return trace(lambda x, y: call_kernel(
                    "tiled_matmul", x, y, chunks=cfg.chunks), a, b)

            targets.append({"name": f"tiled_matmul[{label}]", "trace": run,
                            "context": {}})
        elif op == "flash_attention" and dims:

            def run(cfg=cfg, hd=dims[1], n_rep=k or 1, window=n,
                    tdtype=tdtype):
                q = torch.zeros((1, 128, n_rep, hd), dtype=tdtype)
                kv = torch.zeros((1, 128, 1, hd), dtype=tdtype)
                return trace(lambda a, b, c: call_kernel(
                    "flash_attention", a, b, c, bq=cfg.bq, bk=cfg.bk,
                    window=window), q, kv, kv)

            targets.append({"name": f"flash_attention[{label}]",
                            "trace": run, "context": {}})
    if not targets:
        for dims, k, n in _DEFAULT_SCATTER:
            scatter_target(f"default:{dims[0]}x{dims[1]},k={k},n={n}", dims,
                           k, n, torch.float32, None)
    return targets
