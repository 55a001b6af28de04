"""What each launch of the port's kernels takes of an SM: threads, static
and dynamic shared memory, registers. ``launch_resources(op, ...)`` lists
the launches one call of a wrapper makes, priced in plain Python from the
same formulas as the launchers in ``csrc/``; the tuner's candidate filter
and the ``smem-budget`` analysis rule read it, on any host.

Static shared memory and registers per thread come from the build
(``BUILD``: nvcc for sm_90a, as ``-Xptxas -v`` and
``cudaFuncGetAttributes`` report them). Each source exports
``<source>_launch_query(kernel, args, out)``, which gives the same five
numbers from the card: ``chip_smoke.py`` holds ``launch_resources`` to it
at every path's shapes and every tuner candidate, so an edit that moves a
kernel's registers or a launcher's shared memory shows there.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import REGISTERS_PER_BLOCK, SMEM_BUDGET_BYTES

_T = {4: "float", 8: "double"}

# every kernel function of each source, in its launch query's order
KERNELS = {
    "block_topk": tuple(
        [f"diff_topk_payload_kernel<{t}, {s}, {v}>" for t in ("float", "double")
         for s in ("true", "false") for v in ("true", "false")]
        + [f"block_topk_payload_kernel<{t}, {v}>" for t in ("float", "double")
           for v in ("true", "false")]
        + [f"block_topk_dense_kernel<{t}, {v}>" for t in ("float", "double")
           for v in ("true", "false")]),
    "scatter_accum": tuple(
        [f"accum_count_kernel<{t}, {f}>" for t in ("float", "double")
         for f in ("true", "false")]
        + ["accum_scan_kernel"]
        + [f"accum_place_kernel<{t}, {f}>" for t in ("float", "double")
           for f in ("true", "false")]
        + ["accum_sum_kernel<float>", "accum_sum_kernel<double>"]
        + [f"block_scatter_kernel<{t}, {v}>" for t in ("float", "double")
           for v in ("true", "false")]),
    "hess_update": ("hess_update_kernel<float>", "hess_update_kernel<double>"),
    "tiled_matmul": ("tiled_matmul_kernel", "tiled_matmul_small_n_rows_kernel",
                     "tiled_matmul_small_n_cols_kernel",
                     "tiled_matmul_sum_partials_kernel",
                     "tiled_matmul_small_k_kernel"),
    "flash_attention": tuple(
        f"flash_attention_kernel<float, {hd}, {bq}, {bk}>" for hd in (64, 128)
        for bq in (128, 64) for bk in (128, 64)),
    "flash_attention_wgmma": tuple(
        f"flash_attention_kernel_wgmma<{hd}, {bq}, {bk}>" for hd in (64, 128)
        for bq in (128, 64) for bk in (128, 64)),
}

# (registers a thread, static shared bytes) of each kernel function, from
# nvcc 12.8 for sm_90a
BUILD = {
    "diff_topk_payload_kernel<float, true, true>": (92, 800),
    "diff_topk_payload_kernel<float, true, false>": (128, 800),
    "diff_topk_payload_kernel<float, false, true>": (90, 800),
    "diff_topk_payload_kernel<float, false, false>": (127, 800),
    "diff_topk_payload_kernel<double, true, true>": (119, 864),
    "diff_topk_payload_kernel<double, true, false>": (127, 864),
    "diff_topk_payload_kernel<double, false, true>": (119, 864),
    "diff_topk_payload_kernel<double, false, false>": (127, 864),
    "block_topk_payload_kernel<float, true>": (89, 736),
    "block_topk_payload_kernel<float, false>": (96, 736),
    "block_topk_payload_kernel<double, true>": (128, 736),
    "block_topk_payload_kernel<double, false>": (124, 736),
    "block_topk_dense_kernel<float, true>": (104, 208),
    "block_topk_dense_kernel<float, false>": (128, 208),
    "block_topk_dense_kernel<double, true>": (128, 208),
    "block_topk_dense_kernel<double, false>": (64, 208),
    "accum_count_kernel<float, true>": (32, 0),
    "accum_count_kernel<float, false>": (32, 0),
    "accum_count_kernel<double, true>": (32, 0),
    "accum_count_kernel<double, false>": (32, 0),
    "accum_scan_kernel": (57, 4096),
    "accum_place_kernel<float, true>": (40, 128),
    "accum_place_kernel<float, false>": (40, 128),
    "accum_place_kernel<double, true>": (47, 128),
    "accum_place_kernel<double, false>": (48, 128),
    "accum_sum_kernel<float>": (32, 0),
    "accum_sum_kernel<double>": (32, 0),
    "block_scatter_kernel<float, true>": (48, 0),
    "block_scatter_kernel<float, false>": (46, 0),
    "block_scatter_kernel<double, true>": (63, 0),
    "block_scatter_kernel<double, false>": (62, 0),
    "hess_update_kernel<float>": (48, 128),
    "hess_update_kernel<double>": (48, 128),
    "tiled_matmul_kernel": (64, 8320),
    "tiled_matmul_small_n_rows_kernel": (72, 128),
    "tiled_matmul_small_n_cols_kernel": (75, 32768),
    "tiled_matmul_sum_partials_kernel": (32, 0),
    "tiled_matmul_small_k_kernel": (54, 0),
    "flash_attention_kernel<float, 64, 128, 128>": (249, 0),
    "flash_attention_kernel<float, 64, 128, 64>": (168, 0),
    "flash_attention_kernel<float, 64, 64, 128>": (128, 0),
    "flash_attention_kernel<float, 64, 64, 64>": (112, 0),
    "flash_attention_kernel<float, 128, 128, 128>": (254, 0),
    "flash_attention_kernel<float, 128, 128, 64>": (210, 0),
    "flash_attention_kernel<float, 128, 64, 128>": (154, 0),
    "flash_attention_kernel<float, 128, 64, 64>": (128, 0),
    "flash_attention_kernel_wgmma<64, 128, 128>": (153, 112),
    "flash_attention_kernel_wgmma<64, 128, 64>": (104, 112),
    "flash_attention_kernel_wgmma<64, 64, 128>": (153, 112),
    "flash_attention_kernel_wgmma<64, 64, 64>": (104, 112),
    "flash_attention_kernel_wgmma<128, 128, 128>": (165, 64),
    "flash_attention_kernel_wgmma<128, 128, 64>": (137, 112),
    "flash_attention_kernel_wgmma<128, 64, 128>": (190, 64),
    "flash_attention_kernel_wgmma<128, 64, 64>": (137, 112),
}

# the launchers' constants (csrc/block_topk.cu, scatter_accum.cu,
# flash_attention_wgmma.cu)
_SELECT_BYTES = (2048 + 4 + 1024 + 16384) * 4
_SCATTER_WARPS, _SUM_WARPS, _ACC_BUDGET = 8, 4, 192 * 1024
_WGMMA_STAGE_BYTES = 200 * 1024


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: ``kernel`` of ``csrc/<source>.cu`` at
    ``threads`` a block with ``dynamic_smem`` bytes; ``arg`` is what the
    source's launch query takes for it (its args[0])."""

    source: str
    kernel: str
    threads: int
    dynamic_smem: int
    arg: int = 0

    @property
    def index(self) -> int:
        return KERNELS[self.source].index(self.kernel)

    @property
    def registers(self) -> int:
        return BUILD[self.kernel][0]

    @property
    def static_smem(self) -> int:
        return BUILD[self.kernel][1]

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem

    @property
    def block_registers(self) -> int:
        return self.registers * self.threads

    def fits(self, smem_budget: int = SMEM_BUDGET_BYTES) -> bool:
        return (self.smem <= smem_budget
                and self.block_registers <= REGISTERS_PER_BLOCK)

    def describe(self) -> str:
        return (f"{self.kernel}: {self.threads} threads x {self.registers} "
                f"registers = {self.block_registers}, shared {self.static_smem}"
                f" + {self.dynamic_smem} = {self.smem} bytes")


def _bool(x: bool) -> str:
    return "true" if x else "false"


def select_smem(k: int, itemsize: int) -> int:
    """K1/K5/K6's dynamic shared bytes: the radix histograms and the
    candidates, or the payload of k entries where it is larger."""
    return max(int(k) * (itemsize + 4), _SELECT_BYTES)


def band_smem(block: int, itemsize: int) -> int:
    """K4's dynamic shared bytes: a band of a tile's rows within 192 KiB,
    and a bitmap of its cells per chunk parity."""
    row_bytes = block * itemsize
    max_rows = _ACC_BUDGET // row_bytes
    if max_rows < 1:
        raise ValueError(f"block_scatter_accumulate: a row of {block} "
                         f"entries is over the kernel's band budget")
    nbands = -(-block // max_rows)
    band_rows = -(-block // nbands)
    words = -(-(band_rows * block) // 32)
    return band_rows * row_bytes + 2 * words * 4


def _topk(op: str, dtype, k: int, vec: bool, shared_b: bool) -> list:
    t = _T[dtype.itemsize]
    if op == "diff_topk_payload":
        name = f"diff_topk_payload_kernel<{t}, {_bool(shared_b)}, {_bool(vec)}>"
    elif op == "block_topk_payload":
        name = f"block_topk_payload_kernel<{t}, {_bool(vec)}>"
    else:
        name, k = f"block_topk_dense_kernel<{t}, {_bool(vec)}>", 0
    return [Launch("block_topk", name, 512, select_smem(k, dtype.itemsize),
                   int(k))]


def _scatter(dtype, plan) -> list:
    size = dtype.itemsize
    t = _T[size]
    out = []
    if plan.entries > 0:
        db = plan.digit_bits
        for p in range(plan.passes):
            first = _bool(p == 0)
            out += [Launch("scatter_accum", f"accum_count_kernel<{t}, {first}>",
                           32 * _SCATTER_WARPS, (1 << db) * 4, db),
                    Launch("scatter_accum", "accum_scan_kernel", 256, 0),
                    Launch("scatter_accum", f"accum_place_kernel<{t}, {first}>",
                           32 * _SCATTER_WARPS,
                           (_SCATTER_WARPS + 1) * (1 << db) * 4, db)]
    out.append(Launch("scatter_accum", f"accum_sum_kernel<{t}>",
                      32 * _SUM_WARPS, _SUM_WARPS * (size << plan.log_sub),
                      plan.log_sub))
    return out


def _flash(dtype, hd: int, bq: int, bk: int) -> list:
    if dtype == torch.bfloat16:
        q, tile = bq * hd * 2, bk * hd * 2
        stages = min(4, (_WGMMA_STAGE_BYTES - q) // (2 * tile))
        return [Launch("flash_attention_wgmma",
                       f"flash_attention_kernel_wgmma<{hd}, {bq}, {bk}>",
                       (bq // 64) * 128 + 32, q + 2 * stages * tile + 1024)]
    return [Launch("flash_attention",
                   f"flash_attention_kernel<float, {hd}, {bq}, {bk}>", 256,
                   (hd * (bq + 1) + hd * (bk + 1) + bq * (bk + 1)) * 4)]


def launch_resources(op: str, **p) -> list:
    """The launches one call of wrapper ``op`` makes, with the wrapper's
    launch parameters ``p``:

    * diff_topk_payload / block_topk_payload / block_topk: ``dtype``,
      ``k``, ``vec`` (16-byte rows), ``shared_b`` (K1: one b for every
      silo);
    * scatter_accumulate: ``dtype`` and ``plan`` (a ``ScatterPlan``);
    * block_scatter_accumulate: ``dtype``, ``block``, ``vec``;
    * hess_update: ``dtype``;
    * tiled_matmul: ``route``, ``layout`` ("rows" or "cols" for
      small_n), ``chunks``;
    * flash_attention: ``dtype``, ``hd``, ``bq``, ``bk``."""
    if op in ("diff_topk_payload", "block_topk_payload", "block_topk"):
        return _topk(op, p["dtype"], p.get("k", 0), p.get("vec", True),
                     p.get("shared_b", False))
    if op == "scatter_accumulate":
        return _scatter(p["dtype"], p["plan"])
    if op == "block_scatter_accumulate":
        size = p["dtype"].itemsize
        return [Launch("scatter_accum",
                       f"block_scatter_kernel<{_T[size]}, "
                       f"{_bool(p.get('vec', True))}>", 256,
                       band_smem(int(p["block"]), size), int(p["block"]))]
    if op == "hess_update":
        return [Launch("hess_update",
                       f"hess_update_kernel<{_T[p['dtype'].itemsize]}>", 256,
                       0)]
    if op == "tiled_matmul":
        route = p["route"]
        if route == "tiled":
            return [Launch("tiled_matmul", "tiled_matmul_kernel", 256, 0)]
        if route == "small_k":
            return [Launch("tiled_matmul", "tiled_matmul_small_k_kernel", 256,
                           0)]
        rows = p.get("layout", "rows") == "rows"
        out = [Launch("tiled_matmul",
                      "tiled_matmul_small_n_rows_kernel" if rows
                      else "tiled_matmul_small_n_cols_kernel",
                      128 if rows else 256, 0)]
        if p.get("chunks", 1) > 1:
            out.append(Launch("tiled_matmul",
                              "tiled_matmul_sum_partials_kernel", 256, 0))
        return out
    if op == "flash_attention":
        return _flash(p["dtype"], int(p["hd"]), int(p["bq"]), int(p["bk"]))
    raise KeyError(f"launch_resources: no kernel wrapper {op!r}")


def within_budget(launches, smem_budget: int = SMEM_BUDGET_BYTES) -> bool:
    return all(lc.fits(smem_budget) for lc in launches)


def query(launch: Launch) -> dict:
    """What the card reports of ``launch`` through its source's launch
    query: registers, static shared bytes, max threads a block, and the
    threads and dynamic shared bytes its launcher gives it. Card only."""
    from . import _cuda

    lib = _cuda.library(launch.source)
    args = (ctypes.c_longlong * 1)(launch.arg)
    out = (ctypes.c_longlong * 5)()
    err = getattr(lib, f"{launch.source}_launch_query")(
        launch.index, ctypes.cast(args, ctypes.c_void_p),
        ctypes.cast(out, ctypes.c_void_p))
    _cuda.check(err, f"{launch.source}_launch_query({launch.kernel})")
    return {"registers": out[0], "static_smem": out[1],
            "max_threads": out[2], "threads": out[3], "dynamic_smem": out[4]}
