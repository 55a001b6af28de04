"""LibSVM-shaped synthetic logistic-regression data (Table 3 stand-ins).

Counterpart of ``repro.data.synthetic.make_libsvm_like``: the same
shapes and the same recipe (binary features of density 0.15, a planted
linear teacher, Bernoulli labels), drawn from a ``torch.Generator``.
The draws differ from the reference's JAX PRNG streams; parity tests
hand the reference's own arrays to the port (``repro_torch.interop``).
"""

from __future__ import annotations

import math

import torch

from ..core.objectives import LogRegData

# Table 3 of the paper
LIBSVM_SHAPES = {
    "a1a": dict(n=16, m=100, d=123),
    "a9a": dict(n=80, m=407, d=123),
    "w7a": dict(n=50, m=492, d=300),
    "w8a": dict(n=142, m=350, d=300),
    "phishing": dict(n=100, m=110, d=68),
}


def make_libsvm_like(generator: torch.Generator, name: str,
                     lam: float = 1e-3, scale: float = 1.0,
                     dtype: torch.dtype = torch.float64) -> LogRegData:
    """Stand-in with the dataset's (n, m, d), drawn on the generator's
    device in ``dtype``."""
    spec = LIBSVM_SHAPES[name]
    n, m, d = spec["n"], spec["m"], spec["d"]
    dev = generator.device
    density = 0.15
    mask = torch.rand((n, m, d), generator=generator, device=dev) < density
    a = mask.to(dtype) * scale
    w = torch.randn(d, generator=generator, device=dev,
                    dtype=dtype) / math.sqrt(d * density)
    logits = torch.einsum("nmd,d->nm", a, w)
    neg = torch.bernoulli(torch.sigmoid(logits), generator=generator)
    b = torch.where(neg > 0, -1.0, 1.0).to(dtype)
    return LogRegData(a=a, b=b, lam=lam)
