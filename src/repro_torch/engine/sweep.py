"""Declarative experiment sweeps for the FedNL family, counterpart of
``repro.engine.sweep``.

A grid is a list of ``ExperimentSpec`` cells (method x compressor x
level x seeds), and ``Sweep.run`` executes each against one problem.
The reference stacks a cell's seeds with ``jax.vmap`` into one jitted
program; ``vmap`` cannot pass through the port's ctypes-bound kernels,
so the port runs each seed as ``init`` then ``step`` a round, exactly
``MethodBase.run``. Its contract is stronger than the reference's
1e-10: a sweep cell equals the serial runs of its seeds bit for bit.

Results come back as ``CellResult`` (iterate and gap histories, the
analytic, measured and entropy-coded cumulative-bits curves, the cell's
``us_per_round`` and the traffic model's ``seconds_per_round``) and as
tidy row dicts via ``SweepResult.records()``, with the reference's keys
in its order.

``mesh=`` (a ``DeviceMesh``) runs the plain-FedNL cells through
``core/federated.py``'s ``run_fednl_sharded``, silos split over the
mesh's "data" axis, where the axis divides the silo count; every other
cell takes the serial path, as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from . import records as rec
from .method import Oracles, make_method


def build_compressor(family: str, level=None):
    """String-keyed compressor factory: ``core.compressors``'s
    ``make_compressor``."""
    from ..core.compressors import make_compressor

    return make_compressor(family, level)


@dataclass(frozen=True)
class ExperimentSpec:
    """One cell of a sweep grid.

    method:     registry key ("fednl", "fednl-pp", "fednl-bc", ...)
    compressor: compressor family for ``build_compressor`` (None for
                methods that take none, e.g. "newton")
    level:      the family's level knob (rank / k / s)
    params:     extra method kwargs (alpha, option, mu, tau, p, eta,
                l_star, model_compressor=("topk", k), ...)
    seeds:      round-draw seeds, run one after another
    num_rounds: communication rounds
    name:       display label (made from the rest when omitted)
    cohort:     optional ``core.cohort.CohortSpec``, passed to methods
                that take one ("fednl-cohort"); it also prices the
                ``seconds_per_round`` column on the cohort's link and K
    """

    method: str
    compressor: Optional[str] = None
    level: Optional[float] = None
    params: Mapping[str, Any] = field(default_factory=dict)
    seeds: Sequence[int] = (0,)
    num_rounds: int = 50
    name: Optional[str] = None
    cohort: Optional[Any] = None

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        parts = [self.method]
        if self.compressor:
            lvl = "" if self.level is None else f"{self.level:g}"
            parts.append(f"{self.compressor}{lvl}")
        if self.cohort is not None:
            pop = self.cohort.population
            parts.append(f"K{self.cohort.cohort}" +
                         (f"ofN{pop}" if pop is not None else ""))
        return ":".join(parts)

    def build(self, oracles: Oracles):
        """Instantiate the method object for this cell."""
        comp = (build_compressor(self.compressor, self.level)
                if self.compressor else None)
        params = dict(self.params)
        if self.cohort is not None:
            params["cohort"] = self.cohort
        return make_method(self.method, oracles, comp, **params)


@dataclass
class CellResult:
    spec: ExperimentSpec
    xs: np.ndarray        # (num_seeds, num_rounds+1, d) iterate history
    gaps: np.ndarray      # (num_seeds, num_rounds+1) f(x_k) - f*
    bits: np.ndarray      # (num_rounds+1,) cumulative bits/node (analytic)
    us_per_round: float   # the cell's wall clock over all its seeds, over
                          # num_rounds (no compile: kernels are built
                          # before the sweep runs)
    bits_measured: Optional[np.ndarray] = None
                          # (num_rounds+1,) cumulative bits/node, measured
                          # from the method's payload structure
    bits_entropy: Optional[np.ndarray] = None
                          # the same with entropy-coded index streams
    seconds_per_round: Optional[float] = None
                          # simulated uplink seconds per synchronous round
                          # (traffic model); None if link=None


@dataclass
class SweepResult:
    cells: list

    def records(self) -> list[dict]:
        return [row for c in self.cells for row in rec.cell_records(c)]

    def summary(self, target: Optional[float] = None) -> list[dict]:
        return rec.summary_records(self.cells, target)

    def cell(self, label: str) -> CellResult:
        for c in self.cells:
            if c.spec.label == label:
                return c
        raise KeyError(label)


def run_cell(method, x0: torch.Tensor, n: int, num_rounds: int,
             seeds: Sequence[int],
             draws: Optional[Callable[[int], Any]] = None) -> torch.Tensor:
    """One cell: each seed's ``method.run`` in turn; returns the
    (num_seeds, num_rounds+1, d) history. ``draws(seed)`` gives a seed's
    round-draw source (None: the method's own ``RoundDraws(seed)``)."""
    out = []
    for seed in seeds:
        src = None if draws is None else draws(seed)
        kw = {} if src is None else {"draws": src}
        out.append(method.run(x0, n, num_rounds, seed=seed, **kw)[1])
    return torch.stack(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sweep:
    """Run a grid of ``ExperimentSpec`` cells against one problem.

    ``problem`` (to ``run``) is the oracle dict of
    ``data.problems.make_problem``: "grad", "hess", optional "val" and
    "fstar" for gap curves, "n", "d". "val" is evaluated under
    ``torch.func.vmap``, as the reference's under ``jax.vmap``. The
    cells run where the problem's tensors are.

    ``link`` prices each cell's measured wire bits through the traffic
    model (a ``wire.traffic`` preset name or ``LinkModel``) into the
    ``seconds_per_round`` column; ``link=None`` skips it (NaN).
    ``mesh`` (a ``DeviceMesh``) splits the silos of the plain-FedNL
    cells over its ``axis`` (``problem["data"]`` is then needed).
    """

    def __init__(self, specs: Sequence[ExperimentSpec], mesh=None,
                 axis: str = "data", link="wan"):
        self.specs = list(specs)
        self.mesh = mesh
        self.axis = axis
        self.link = link

    def run(self, problem, x0=None, draws=None) -> SweepResult:
        """Run every cell. ``x0`` defaults to zeros in the problem's
        dtype and device. ``draws(spec, seed)`` gives a cell's round-draw
        source per seed (the port's counterpart of the reference's
        ``PRNGKey(seed)``; None, or a None return, leaves the method its
        own ``RoundDraws(seed)`` on the problem's device).

        ``us_per_round`` is the cell's wall clock over all its seeds over
        ``num_rounds``, to a ``torch.cuda.synchronize()`` on a card: it
        counts every seed's rounds and no compile (the reference's counts
        its jit trace; the port's kernels are built before a sweep)."""
        oracles = Oracles(value=problem.get("val"), grad=problem["grad"],
                          hess=problem["hess"])
        n, d = int(problem["n"]), int(problem["d"])
        fstar = problem.get("fstar")
        ref = problem.get("xstar")
        if x0 is None:
            x0 = (torch.zeros(d, dtype=torch.float64) if ref is None
                  else torch.zeros_like(ref))
        dtype, device = x0.dtype, x0.device
        val = problem.get("val")
        cells = []
        for spec in self.specs:
            method = spec.build(oracles)
            cell_draws = (None if draws is None
                          else lambda seed, spec=spec: draws(spec, seed))
            _sync(device)
            t0 = time.perf_counter()
            if self.mesh is not None and self._shardable(spec, problem):
                xs = self._run_sharded(spec, problem, x0, cell_draws)
            else:
                xs = run_cell(method, x0, n, spec.num_rounds, spec.seeds,
                              cell_draws)
            _sync(device)
            wall_us = (time.perf_counter() - t0) * 1e6
            if val is not None:
                # one batched call a cell, as the reference's
                # jax.vmap(jax.vmap(val))
                gaps = torch.func.vmap(torch.func.vmap(val))(xs).cpu().numpy()
                if fstar is not None:
                    gaps = gaps - fstar
            else:
                gaps = np.full(tuple(xs.shape[:2]), np.nan)
            cells.append(CellResult(
                spec=spec,
                xs=xs.cpu().numpy(),
                gaps=gaps,
                bits=rec.bits_curve(method, d, spec.num_rounds),
                bits_measured=rec.measured_bits_curve(
                    method, d, spec.num_rounds, dtype=dtype),
                bits_entropy=rec.entropy_bits_curve(
                    method, d, spec.num_rounds, dtype=dtype),
                us_per_round=wall_us / max(1, spec.num_rounds),
                seconds_per_round=self._cell_seconds(spec, method, d, n,
                                                     dtype),
            ))
        return SweepResult(cells)

    def _cell_seconds(self, spec: ExperimentSpec, method, d: int, n: int,
                      dtype: torch.dtype) -> Optional[float]:
        """Traffic-model pricing for one cell: a ``cohort=`` cell on ITS
        link and cohort size (the round waits for the sampled K, not all
        N registered clients); every other cell on the sweep's ``link``
        over the problem's n silos."""
        if spec.cohort is not None:
            return rec.seconds_per_round(method, d, spec.cohort.cohort,
                                         link=spec.cohort.link, dtype=dtype)
        if self.link is None:
            return None
        return rec.seconds_per_round(method, d, n, link=self.link,
                                     dtype=dtype)


    # -- the sharded path (core/federated.py over the mesh's axis) ----------

    def _shardable(self, spec: ExperimentSpec, problem) -> bool:
        if spec.method != "fednl" or problem.get("data") is None:
            return False
        world = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))
        return int(problem["n"]) % world == 0

    def _run_sharded(self, spec: ExperimentSpec, problem, x0,
                     draws) -> torch.Tensor:
        from ..core.federated import run_fednl_sharded

        comp = build_compressor(spec.compressor, spec.level)
        p = dict(spec.params)
        out = []
        for seed in spec.seeds:
            # FedNL.__init__'s defaults, so a spec runs the same algorithm
            # with and without mesh=
            _, xs = run_fednl_sharded(
                problem["data"], comp, self.mesh, x0, spec.num_rounds,
                alpha=p.get("alpha", 1.0), option=p.get("option", 1),
                mu=p.get("mu", 0.0), axis=self.axis, seed=seed,
                draws=None if draws is None else draws(seed))
            out.append(xs)
        return torch.stack(out)


def run_sweep(specs: Sequence[ExperimentSpec], problem, x0=None,
              mesh=None, axis: str = "data", link="wan",
              draws=None) -> SweepResult:
    """``Sweep(specs, mesh, axis, link).run(problem, x0, draws)``."""
    return Sweep(specs, mesh=mesh, axis=axis, link=link).run(
        problem, x0=x0, draws=draws)
