"""Synthetic federated logistic-regression data, counterpart of
``repro.data.synthetic``.

``make_libsvm_like`` mimics the LibSVM datasets' shapes of Table 3
(a1a, a9a, w7a, w8a, phishing): binary features of density 0.15, a
planted linear teacher, Bernoulli labels. ``make_synthetic(alpha,
beta)`` is the non-IID generator of the paper's Sec. A.14 (Li et al.
2018):

  per silo i: B_i ~ N(0, beta); v_i entries ~ N(B_i, 1);
  features a_ij ~ N(v_i, Sigma) with Sigma_jj = j^{-1.2};
  u_i ~ N(0, alpha); c_i ~ N(u_i, 1); w_i entries ~ N(u_i, 1);
  p_ij = sigmoid(w_i^T a_ij + c_i); b_ij = -1 w.p. p_ij else +1.

``make_iid`` shares one (w, c) pair across silos. Each of the two is a
draw (standard normals and label uniforms from a ``torch.Generator``,
``synthetic_draws`` / ``iid_draws``) followed by a deterministic
construction (``synthetic_from_draws`` / ``iid_from_draws``): torch
cannot reproduce the reference's JAX PRNG streams, so the tests hold
the construction to the reference on the reference's own draws.
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


def _labels(uniform: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """-1 where the uniform falls below sigmoid(logit), else +1 (the
    comparison ``jax.random.bernoulli`` makes)."""
    return torch.where(uniform < torch.sigmoid(logits), -1.0, 1.0).to(
        logits.dtype)


def _sqrt_sigma(d: int, device) -> torch.Tensor:
    """sqrt(Sigma_jj) = sqrt(j^{-1.2}), in f32 as the reference makes it."""
    return torch.sqrt(torch.arange(1, d + 1, dtype=torch.float32,
                                   device=device) ** -1.2)


def synthetic_draws(generator: torch.Generator, n: int, m: int, d: int,
                    dtype: torch.dtype = torch.float64) -> dict:
    """The variates of ``make_synthetic``: standard normals ``z0``..``z5``
    (the reference's ``ks[0]``..``ks[5]`` draws) and the label uniforms
    ``u``."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype)

    return dict(z0=normal(n), z1=normal(n, d), z2=normal(n, m, d),
                z3=normal(n), z4=normal(n), z5=normal(n, d),
                u=torch.rand((n, m), generator=generator, device=dev,
                             dtype=dtype))


def synthetic_from_draws(z: dict, alpha: float, beta: float,
                         lam: float = 1e-3) -> LogRegData:
    """``make_synthetic``'s construction from its draws."""
    d = z["z1"].shape[1]
    b_i = z["z0"] * math.sqrt(beta)
    v = b_i[:, None] + z["z1"]
    a = v[:, None, :] + z["z2"] * _sqrt_sigma(d, z["z2"].device)
    u_i = z["z3"] * math.sqrt(alpha)
    c_i = u_i + z["z4"]
    w = u_i[:, None] + z["z5"]
    logits = torch.einsum("nmd,nd->nm", a, w) + c_i[:, None]
    return LogRegData(a=a, b=_labels(z["u"], logits), lam=lam)


def make_synthetic(generator: torch.Generator, alpha: float, beta: float,
                   n: int = 30, m: int = 200, d: int = 100,
                   lam: float = 1e-3,
                   dtype: torch.dtype = torch.float64) -> LogRegData:
    """Sec. A.14's non-IID data, drawn on the generator's device."""
    return synthetic_from_draws(synthetic_draws(generator, n, m, d, dtype),
                                alpha, beta, lam)


def iid_draws(generator: torch.Generator, n: int, m: int, d: int,
              dtype: torch.dtype = torch.float64) -> dict:
    """The variates of ``make_iid``: standard normals ``z0``..``z3`` (the
    reference's ``ks[0]``..``ks[3]``) and the label uniforms ``u``."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype)

    return dict(z0=normal(n), z1=normal(n, m, d), z2=normal(d),
                z3=normal(), u=torch.rand((n, m), generator=generator,
                                          device=dev, dtype=dtype))


def iid_from_draws(z: dict, beta: float = 1.0,
                   lam: float = 1e-3) -> LogRegData:
    """``make_iid``'s construction from its draws."""
    d = z["z2"].shape[0]
    v = (z["z0"] * math.sqrt(beta))[:, None].expand(-1, d)
    a = v[:, None, :] + z["z1"] * _sqrt_sigma(d, z["z1"].device)
    logits = torch.einsum("nmd,d->nm", a, z["z2"]) + z["z3"]
    return LogRegData(a=a, b=_labels(z["u"], logits), lam=lam)


def make_iid(generator: torch.Generator, beta: float = 1.0, n: int = 30,
             m: int = 200, d: int = 100, lam: float = 1e-3,
             dtype: torch.dtype = torch.float64) -> LogRegData:
    """IID data: one (w, c) shared by every silo."""
    return iid_from_draws(iid_draws(generator, n, m, d, dtype), beta, lam)
