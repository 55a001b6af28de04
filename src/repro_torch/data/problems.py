"""Benchmark problems: eq. (10) on the LibSVM-shaped stand-ins (Table 3
sizes) or the Sec. A.14 synthetic generator, packaged as the oracle dict
the engine consumes (counterpart of ``repro.data.problems``).
"""

from __future__ import annotations

import torch

from ..core.newton import newton_run
from ..core.objectives import (
    LogRegData,
    batch_grad,
    batch_hess,
    global_value,
    lipschitz_constants,
)
from ..device import resolve_device
from .synthetic import LIBSVM_SHAPES, make_libsvm_like, make_synthetic


def problem_from_data(data: LogRegData, newton_rounds: int = 25) -> dict:
    """Oracles, x* (Newton from 0) and constants for given data."""
    grad_fn = lambda x: batch_grad(x, data)
    hess_fn = lambda x: batch_hess(x, data)
    val_fn = lambda x: global_value(x, data)
    d = data.a.shape[-1]
    x0 = torch.zeros(d, dtype=data.a.dtype, device=data.a.device)
    xstar, _ = newton_run(x0, grad_fn, hess_fn, newton_rounds)
    return dict(
        data=data, grad=grad_fn, hess=hess_fn, val=val_fn, xstar=xstar,
        fstar=float(val_fn(xstar)), d=d, n=data.a.shape[0],
        consts=lipschitz_constants(data),
    )


def make_problem(name: str = "a1a", lam: float = 1e-3, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.float64) -> dict:
    """The oracle dict, x* and constants for a Table 3 name ('a1a', ...)
    or 'synthetic:ALPHA:BETA' (Sec. A.14's generator at n=30, m=200,
    d=100), drawn from ``seed`` on ``device`` (the card unless asked)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if name.startswith("synthetic"):
        _, alpha, beta = name.split(":")
        return problem_from_data(make_synthetic(
            gen, float(alpha), float(beta), n=30, m=200, d=100, lam=lam,
            dtype=dtype))
    if name not in LIBSVM_SHAPES:
        raise ValueError(f"unknown problem {name!r}; the port has "
                         f"{sorted(LIBSVM_SHAPES)} and synthetic:ALPHA:BETA")
    return problem_from_data(make_libsvm_like(gen, name, lam=lam,
                                              dtype=dtype))
