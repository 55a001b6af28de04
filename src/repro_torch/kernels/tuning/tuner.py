"""Measurement-driven autotuner for the port's kernel launch parameters,
counterpart of ``src/repro/kernels/tuning/tuner.py``.

For each tuned op a candidate list of ``KernelConfig``s is generated and
filtered by the card's own limits, not the reference's 8 MiB VMEM rule:
every launch the candidate makes must fit a block's shared memory
(static + dynamic <= ``SMEM_BUDGET_BYTES``, 227 KB on sm_90) and the
SM's 65,536 registers (registers x threads), as
``resources.launch_resources`` prices it — the same pricing as the
``smem-budget`` analysis rule, so a tuned pick can never fail that rule.
Where there are more candidates than ``max_measured``, they are pruned by
a roofline estimate of the PORT kernel's own work: its bytes over
``launch/roofline.py``'s ``HBM_BW`` (scaled by the share of the 132 SMs
its grids fill) against its operations over the peak rate; the untuned
default is always measured, so the tuner can only match or beat it on the
measured case. Each survivor is timed (``time_us``: the median of
``reps`` CUDA-event times after a warmup) and the fastest, ties to the
first measured, is recorded in the process-global ``TuningCache`` under
the operand's device kind.

Tuned: K2/K3 ``scatter_accumulate`` (the plan's region width, digit
width and warp segment), K7 ``hess_update`` (the tile edge), K8
``tiled_matmul`` (the small_n route's K chunks) and K9
``flash_attention`` ((bq, bk) in {64, 128}^2). The top-k family (K1, K5,
K6) is not tuned: the reference's only knob there is the choice between
its Pallas kernel and the XLA sort oracle, and the port's counterpart of
the oracle is the plain version, which a wrapper never takes on a card.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .cache import KernelConfig, record

SCATTER_SEGS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
HESS_BLOCKS = (32, 64, 128, 256, 512)
MATMUL_CHUNKS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
SMS = 132  # the H100's streaming multiprocessors


def _roofline():
    from ...launch.roofline import HBM_BW, PEAK_FLOPS_BY_DTYPE

    return float(HBM_BW), PEAK_FLOPS_BY_DTYPE


def _peak(dtype) -> float:
    by = _roofline()[1]
    return by["f64"] if dtype == torch.float64 else \
        by["bf16"] if dtype == torch.bfloat16 else by["f32"]


def _fill(blocks: float, full: float = SMS) -> float:
    """The share of the card a grid of ``blocks`` blocks keeps busy."""
    return min(1.0, max(float(blocks), 1.0) / full)


def time_us(fn: Callable[[], object], reps: int = 3,
            warmup: int = 1) -> float:
    """Median microseconds of ``fn()`` over ``reps`` calls after
    ``warmup`` untimed ones: CUDA events around each call on a card
    (launch cost included, as a caller pays it), the host clock
    otherwise."""
    for _ in range(max(warmup, 0)):
        fn()
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    ts = []
    for _ in range(max(reps, 1)):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def _measure_winner(candidates: Sequence[KernelConfig],
                    run: Callable[[KernelConfig], object],
                    predict: Optional[Callable[[KernelConfig], float]],
                    max_measured: int, reps: int,
                    timer: Optional[Callable] = None):
    """Prune ``candidates`` by the roofline prediction, measure the
    survivors, return (winner, {config: us}). ``timer`` overrides the
    measurement (the deterministic test seam)."""
    cands = list(candidates)
    if not cands:
        raise ValueError("no in-budget candidates to tune over")
    if predict is not None and len(cands) > max_measured:
        cands.sort(key=predict)
        cands = cands[:max_measured]
    timer = timer or (lambda fn: time_us(fn, reps=reps))
    timings = {cfg: float(timer(lambda cfg=cfg: run(cfg))) for cfg in cands}
    winner = min(cands, key=lambda c: timings[c])
    return winner, timings


def _keep_default(default: KernelConfig, predict):
    """``predict`` with the untuned default first: it is always measured."""
    return lambda c: float("-inf") if c == default else predict(c)


# -- scatter_accumulate (K2, K3) ----------------------------------------------


def _scatter_plan(cfg: KernelConfig, shape, k: int, n: int, dtype,
                  symmetric: bool):
    from ..scatter_accum.ops import make_plan

    d0, d1 = (int(s) for s in shape)
    return make_plan(n, k, d0, d1, bool(symmetric),
                     dtype.itemsize, cfg.log_r,
                     cfg.digit_bits, cfg.seg)


def scatter_default(shape, k: int, n: int, dtype,
                    symmetric: bool = False) -> KernelConfig:
    """The untuned plan's fields as a config."""
    from ..scatter_accum.ops import plan

    d0, d1 = (int(s) for s in shape)
    p = plan(n, k, d0, d1, bool(symmetric),
             dtype.itemsize)
    return KernelConfig(log_r=p.log_r, digit_bits=p.digit_bits, seg=p.seg)


def scatter_candidates(shape, k: int, n: int, dtype,
                       symmetric: bool = False) -> list:
    """(log_r, digit_bits, seg) plans for K2 on an (n, k) pair stream
    into ``shape``, the untuned one first: regions from 32 cells to four
    sum warps' worth, the fewest sort passes and one more, every segment
    of ``SCATTER_SEGS``; only plans the launcher takes whose every launch
    fits a block's shared memory and registers."""
    from ..scatter_accum.ops import MAX_DIGIT_BITS, SUM_WARP_BYTES, plan_error

    d0, d1 = (int(s) for s in shape)
    itemsize = dtype.itemsize
    sub_max = (SUM_WARP_BYTES // itemsize).bit_length() - 1
    out = [scatter_default(shape, k, n, dtype, symmetric)]
    for log_r in range(5, sub_max + 3):
        bits = max(1, (-(-(d0 * d1) // (1 << log_r))).bit_length())
        fewest = -(-bits // MAX_DIGIT_BITS)
        for passes in (fewest, fewest + 1):
            db = -(-bits // passes)
            for seg in SCATTER_SEGS:
                cfg = KernelConfig(log_r=log_r, digit_bits=db, seg=seg)
                if cfg in out:
                    continue
                p = _scatter_plan(cfg, shape, k, n, dtype, symmetric)
                if plan_error(p, dtype) is None:
                    out.append(cfg)
    return out


def predict_scatter_us(cfg: KernelConfig, shape, k: int, n: int, dtype,
                       symmetric: bool = False) -> float:
    """Roofline estimate (us) of K2 under ``cfg``: each sort pass reads
    the entries twice (count, place) and writes them once, (4 + itemsize)
    bytes each, and writes, scans and reads the per-chunk digit counts;
    the sum reads the sorted entries and writes the cells. Each phase's
    bytes go at HBM_BW times the share of the SMs its grid fills; the
    adds at the type's peak rate."""
    hbm, _ = _roofline()
    p = _scatter_plan(cfg, shape, k, n, dtype, symmetric)
    size = dtype.itemsize
    pair = 4 + size
    counts = 3 * p.chunks * (1 << p.digit_bits) * 4
    t_sort = (p.passes * (3 * p.entries * pair + counts)
              / (hbm * _fill(p.chunks))) if p.entries else 0.0
    sum_blocks = -(-(-(-p.cells // (1 << p.log_sub))) // 4)
    t_sum = (p.entries * pair + p.cells * size) / (hbm * _fill(sum_blocks))
    return max(t_sort + t_sum, p.entries / _peak(dtype)) * 1e6


def autotune_scatter_accumulate(values, indices, shape,
                                symmetric: bool = False,
                                max_measured: int = 6, reps: int = 3,
                                timer: Optional[Callable] = None,
                                record_winner: bool = True,
                                timings: Optional[dict] = None
                                ) -> KernelConfig:
    """Measure K2's in-budget plans on this very operand and record the
    winner for its (d-bucket, k, n, dtype, device kind) key. Every
    ``autotune_*`` fills ``timings``, when given, with the µs of each
    measured candidate."""
    from ..scatter_accum import scatter_accumulate

    n, k = values.shape
    dtype = values.dtype
    cands = scatter_candidates(shape, k, n, dtype, symmetric)

    def run(cfg: KernelConfig):
        return scatter_accumulate(values, indices, tuple(shape),
                                  symmetric=symmetric, log_r=cfg.log_r,
                                  digit_bits=cfg.digit_bits, seg=cfg.seg)

    predict = _keep_default(cands[0], lambda c: predict_scatter_us(
        c, shape, k, n, dtype, symmetric))
    winner, us = _measure_winner(cands, run, predict, max_measured, reps,
                                 timer)
    if timings is not None:
        timings.update(us)
    if record_winner:
        record("scatter_accumulate", winner, shape=tuple(shape), k=k, n=n,
               dtype=dtype, device=values.device)
    return winner


# -- hess_update (K7) ----------------------------------------------------------


def hess_candidates(shape, dtype) -> list:
    """Square tiles for K7: one 256-thread block per tile whatever its
    edge (the launcher takes any block > 0), 128 bytes of static shared
    memory; every edge of ``HESS_BLOCKS`` within the budget."""
    from ..resources import launch_resources, within_budget

    fits = within_budget(launch_resources("hess_update", dtype=dtype))
    return [KernelConfig(block=b) for b in HESS_BLOCKS if fits]


def autotune_hess_update(h, d, s, alpha: float, reps: int = 3,
                         timer: Optional[Callable] = None,
                         record_winner: bool = True,
                         timings: Optional[dict] = None) -> KernelConfig:
    from ..hess_update import hess_update

    cands = hess_candidates(h.shape, h.dtype)

    def run(cfg: KernelConfig):
        return hess_update(h, d, s, alpha, block=cfg.block)

    # memory-bound at every edge (the same bytes): measure all, no pruning
    winner, us = _measure_winner(cands, run, None, len(cands), reps, timer)
    if timings is not None:
        timings.update(us)
    if record_winner:
        record("hess_update", winner, shape=tuple(h.shape), dtype=h.dtype,
               device=h.device)
    return winner


# -- tiled_matmul (K8) ---------------------------------------------------------


def _small_n(a, b):
    from ..tiled_matmul.ops import _strided, plan

    a32 = _strided(a)
    m, k = a32.shape
    p = plan(m, b.shape[1], k, a32.stride(), a32.data_ptr() % 16 == 0)
    if p.route != "small_n":
        raise ValueError(f"tiled_matmul: {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"takes the {p.route} route, which has no knob")
    return a32, p


def matmul_candidates(a, b) -> list:
    """K chunk counts of the small_n route for a @ b, the untuned one
    first, as the chunk counts they give (``with_chunks``)."""
    from ..tiled_matmul.ops import with_chunks

    a32, p = _small_n(a, b)
    rows = a32.stride()[1] == 1
    out = [KernelConfig(chunks=p.chunks)]
    for c in MATMUL_CHUNKS:
        got = with_chunks(p, a32.shape[1], c, rows).chunks
        if got <= 65535 and KernelConfig(chunks=got) not in out:
            out.append(KernelConfig(chunks=got))
    return out


def predict_matmul_us(cfg: KernelConfig, a, b) -> float:
    """Roofline estimate (us) of the small_n route at ``cfg.chunks``:
    A, B and C once, plus the partial products written and read back
    when K is cut; bytes at HBM_BW times the share of 528 blocks (4 a
    SM) the grid fills, the products at the f32 peak."""
    hbm, _ = _roofline()
    m, k = a.shape
    n = b.shape[1]
    rows = _small_n(a, b)[0].stride()[1] == 1
    c = int(cfg.chunks)
    nbytes = 4 * (m * k + k * n + m * n) + (2 * c * m * n * 4 if c > 1 else 0)
    blocks = (m if rows else -(-m // 128)) * c
    return max(nbytes / (hbm * _fill(blocks, 4 * SMS)),
               2 * m * n * k / _peak(torch.float32)) * 1e6


def autotune_tiled_matmul(a, b, max_measured: int = 6, reps: int = 3,
                          timer: Optional[Callable] = None,
                          record_winner: bool = True,
                          timings: Optional[dict] = None) -> KernelConfig:
    """Measure the small_n route's chunk counts on a @ b and record the
    winner for (A's (M, K), N, device kind)."""
    from ..tiled_matmul import tiled_matmul

    cands = matmul_candidates(a, b)

    def run(cfg: KernelConfig):
        return tiled_matmul(a, b, chunks=cfg.chunks)

    predict = _keep_default(cands[0], lambda c: predict_matmul_us(c, a, b))
    winner, us = _measure_winner(cands, run, predict, max_measured, reps,
                                 timer)
    if timings is not None:
        timings.update(us)
    if record_winner:
        record("tiled_matmul", winner, shape=tuple(a.shape), n=b.shape[1],
               dtype=torch.float32, device=a.device)
    return winner


# -- flash_attention (K9) ------------------------------------------------------


def flash_candidates(hd: int, dtype) -> list:
    """(bq, bk) in ``TILES``^2, (128, 128) first, each within a block's
    shared memory and registers on its route (wgmma for bf16, FFMA for
    f32)."""
    from ..flash_attention.ops import DEFAULT_TILES, TILES
    from ..resources import launch_resources, within_budget

    pairs = [DEFAULT_TILES] + [(q, k) for q in TILES for k in TILES
                               if (q, k) != DEFAULT_TILES]
    return [KernelConfig(bq=q, bk=k) for q, k in pairs
            if within_budget(launch_resources("flash_attention", dtype=dtype,
                                              hd=hd, bq=q, bk=k))]


def autotune_flash_attention(q, k, v, window: int | None = None,
                             reps: int = 3, timer: Optional[Callable] = None,
                             record_winner: bool = True,
                             timings: Optional[dict] = None) -> KernelConfig:
    """Measure every in-budget tile pair on this operand (the roofline is
    the same for all: no pruning) and record the winner for (T, hd),
    n_rep, the window and the type."""
    from ..flash_attention import flash_attention

    _, t, h, hd = q.shape
    cands = flash_candidates(hd, q.dtype)

    def run(cfg: KernelConfig):
        return flash_attention(q, k, v, bq=cfg.bq, bk=cfg.bk, window=window)

    winner, us = _measure_winner(cands, run, None, len(cands), reps, timer)
    if timings is not None:
        timings.update(us)
    if record_winner:
        record("flash_attention", winner, shape=(t, hd), k=h // k.shape[2],
               n=window, dtype=q.dtype, device=q.device)
    return winner
