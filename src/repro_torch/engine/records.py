"""Tidy-record emission and communication accounting for sweep results,
counterpart of ``repro.engine.records`` (same functions, same row keys
in the same order).

The paper's x-axis is cumulative communicated bits per node; every cell
of a sweep carries an analytic bits curve (``bits_curve``) AND a
measured one (``measured_bits_curve`` — per-round wire sizes from the
compressor payload structure via ``measured_bits_per_round``) next to
its gap curve. A fourth column, ``seconds_per_round``, prices the
measured wire through the traffic model (``repro_torch.wire.traffic``)
into simulated wall-clock. ``records`` flattens a sweep into plain dicts
(one row per (cell, seed, round)).

The reference measures at its ambient float (f64 under x64); the port
has none, so the measured functions take ``dtype`` (f64 by default) and
the sweep passes its problem's.
"""

from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch


def uplink_bits_per_round(method, d: int) -> float:
    """Total per-round communication charged on the paper's x-axis.

    Methods with bidirectional compression (FedNL-BC and friends) return
    an (uplink, downlink) tuple from ``bits_per_round``; the figures
    charge the sum."""
    b = method.bits_per_round(d)
    if isinstance(b, tuple):
        return float(sum(b))
    return float(b)


def measured_bits_per_round(method, d: int, index_coding: str = "raw",
                            dtype: torch.dtype = torch.float64) -> float:
    """Total per-round communication as MEASURED from the method's
    payload structure (``method.measured_bits_per_round``). A method
    without one returns the analytic number: its wire is dense floats,
    so claim == wire by construction. ``index_coding="entropy"`` charges
    the sparsifier index streams log2 C(d^2, k) — the third accounting
    column of sweep records. ``index_coding`` and ``dtype`` reach a
    method's own function only where its signature takes them."""
    fn = getattr(method, "measured_bits_per_round", None)
    if fn is None:
        return uplink_bits_per_round(method, d)
    params = inspect.signature(fn).parameters
    kw = {}
    if "index_coding" in params:
        kw["index_coding"] = index_coding
    if "dtype" in params:
        kw["dtype"] = dtype
    b = fn(d, **kw)
    if isinstance(b, tuple):
        return float(sum(b))
    return float(b)


def init_bits(method, d: int) -> float:
    """One-time setup cost (e.g. shipping H_i^0); 0 when undefined."""
    fn = getattr(method, "init_bits", None)
    return float(fn(d)) if fn is not None else 0.0


def bits_curve(method, d: int, num_rounds: int) -> np.ndarray:
    """(num_rounds+1,) cumulative bits per node, paper accounting."""
    per = uplink_bits_per_round(method, d)
    return init_bits(method, d) + per * np.arange(num_rounds + 1)


def measured_bits_curve(method, d: int, num_rounds: int,
                        dtype: torch.dtype = torch.float64) -> np.ndarray:
    """(num_rounds+1,) cumulative MEASURED bits per node: per-round wire
    sizes from the payload structure; the one-time init cost stays the
    analytic dense-symmetric ship (there is no payload for it)."""
    per = measured_bits_per_round(method, d, dtype=dtype)
    return init_bits(method, d) + per * np.arange(num_rounds + 1)


def entropy_bits_curve(method, d: int, num_rounds: int,
                       dtype: torch.dtype = torch.float64) -> np.ndarray:
    """(num_rounds+1,) cumulative measured bits with the sparsifier
    index streams entropy-coded (an estimate; the codec is not run):
    <= the raw measured curve by construction."""
    per = measured_bits_per_round(method, d, index_coding="entropy",
                                  dtype=dtype)
    return init_bits(method, d) + per * np.arange(num_rounds + 1)


def seconds_per_round(method, d: int, n: int, link="wan", seed: int = 0,
                      dtype: torch.dtype = torch.float64) -> float:
    """Simulated wall-clock seconds for ONE synchronous round: the
    method's MEASURED per-round wire bits priced through the traffic
    model (``wire.traffic.round_seconds``) for an ``n``-silo cohort on
    ``link`` (a preset name or ``LinkModel``). The server waits for the
    straggler, so heterogeneous links make ``n`` matter."""
    from ..wire.traffic import round_seconds

    per = measured_bits_per_round(method, d, dtype=dtype)
    return round_seconds(per, link, n=n, seed=seed)


def seconds_curve(method, d: int, n: int, num_rounds: int, link="wan",
                  seed: int = 0,
                  dtype: torch.dtype = torch.float64) -> np.ndarray:
    """(num_rounds+1,) cumulative simulated seconds — the time-domain
    twin of ``measured_bits_curve`` (same per-round wire size, priced
    by the traffic model; the one-time init ship is charged too)."""
    from ..wire import traffic

    return traffic.seconds_curve(
        measured_bits_per_round(method, d, dtype=dtype), link, n,
        num_rounds, init_bits=init_bits(method, d), seed=seed)


def bits_to_accuracy(gap_curve, bits: np.ndarray, target: float) -> float:
    """First cumulative-bits value at which gap <= target (inf if never)."""
    gap_curve = np.asarray(gap_curve)
    idx = np.nonzero(gap_curve <= target)[0]
    if len(idx) == 0:
        return float("inf")
    return float(bits[idx[0]])


def rounds_to_accuracy(gap_curve, target: float) -> int:
    idx = np.nonzero(np.asarray(gap_curve) <= target)[0]
    return int(idx[0]) if len(idx) else -1


def cell_records(cell) -> list[dict]:
    """One tidy row per (seed, round) for a finished ``CellResult``.
    Three accounting columns side by side: ``bits`` is the paper's
    analytic curve, ``bits_measured`` the wire sizes measured from the
    payload structure (raw 32-bit index streams), ``bits_entropy`` the
    same wire with entropy-coded index streams."""
    spec = cell.spec
    measured = getattr(cell, "bits_measured", None)
    if measured is None:
        measured = cell.bits
    entropy = getattr(cell, "bits_entropy", None)
    if entropy is None:
        entropy = measured
    spr = getattr(cell, "seconds_per_round", None)
    spr = float("nan") if spr is None else float(spr)
    rows = []
    for si, seed in enumerate(spec.seeds):
        for k in range(cell.gaps.shape[1]):
            rows.append(
                dict(
                    name=spec.label,
                    method=spec.method,
                    compressor=spec.compressor or "",
                    level=spec.level if spec.level is not None else "",
                    seed=seed,
                    round=k,
                    bits=float(cell.bits[k]),
                    bits_measured=float(measured[k]),
                    bits_entropy=float(entropy[k]),
                    gap=float(cell.gaps[si, k]),
                    us_per_round=cell.us_per_round,
                    seconds_per_round=spr,
                )
            )
    return rows


def summary_records(cells, target: Optional[float] = None) -> list[dict]:
    """One row per cell: wall-clock and (optionally) bits/rounds to
    ``target`` accuracy for the first seed (the paper's single-run
    figures) plus the across-seed worst case."""
    rows = []
    for cell in cells:
        measured = getattr(cell, "bits_measured", None)
        if measured is None:
            measured = cell.bits
        entropy = getattr(cell, "bits_entropy", None)
        if entropy is None:
            entropy = measured
        row = dict(
            name=cell.spec.label,
            method=cell.spec.method,
            compressor=cell.spec.compressor or "",
            level=cell.spec.level if cell.spec.level is not None else "",
            num_seeds=len(cell.spec.seeds),
            bits_per_round=float(cell.bits[1] - cell.bits[0])
            if len(cell.bits) > 1 else 0.0,
            bits_per_round_measured=float(measured[1] - measured[0])
            if len(measured) > 1 else 0.0,
            bits_per_round_entropy=float(entropy[1] - entropy[0])
            if len(entropy) > 1 else 0.0,
            us_per_round=cell.us_per_round,
            seconds_per_round=float("nan")
            if getattr(cell, "seconds_per_round", None) is None
            else float(cell.seconds_per_round),
        )
        if target is not None:
            row["bits_to_target"] = bits_to_accuracy(
                cell.gaps[0], cell.bits, target)
            row["rounds_to_target"] = rounds_to_accuracy(cell.gaps[0], target)
            row["bits_to_target_worst_seed"] = max(
                bits_to_accuracy(g, cell.bits, target) for g in cell.gaps)
        rows.append(row)
    return rows
