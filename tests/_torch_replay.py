"""The reference's random draws, replayed into the port.

The port draws from ``torch.Generator`` streams, which cannot reproduce
``jax.random``. A port method takes its draws from a round-draw source;
``Replay`` is one that hands it, in order, what the reference's step
splits from its key. ``schedule`` walks the reference's split schedule
of each method and fills a ``Replay`` with the same variates, each made
by the same JAX call the reference makes on the same key.

Every JAX computation here runs inside ``jax.enable_x64(True)``. The
draws of a seed are made once per process and shared by the replays
that ask for them (the port reads them and writes none).
"""

from __future__ import annotations

import collections
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import compressors as tc

jr = jax.random


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class Replay:
    """A round-draw source of prepared draws, one queue per kind."""

    def __init__(self):
        self.queues = collections.defaultdict(collections.deque)

    def push(self, kind: str, value) -> None:
        self.queues[kind].append(value)

    def left(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def silos(self, comp, n, shape, dtype):
        return self.queues["silos"].popleft()

    def active(self, n, tau):
        return self.queues["active"].popleft()

    def coin(self, p):
        return self.queues["coin"].popleft()

    def oracle(self, fn):
        return self.queues["oracle"].popleft()


@functools.lru_cache(maxsize=None)
def _silo_draw(kind: str, shape: tuple, level):
    """A jitted, silo-vmapped reference draw: the same JAX call each
    reference compressor makes on its key."""
    if kind == "randk":
        size = math.prod(shape)
        one = lambda key: jr.choice(key, size, (min(level, size),),
                                    replace=False)
    elif kind == "dithering":
        # the uniforms jax.random.bernoulli(key, prob) compares with prob
        one = lambda key: jr.uniform(key, shape, jnp.float64)
    else:
        one = lambda key: jr.bernoulli(key, level, shape)
    return jax.jit(jax.vmap(one))


def compressor_draws(comp, keys, shape):
    """The variates the reference draws for port compressor ``comp``'s
    counterpart on each of ``keys`` at ``shape`` (stacked); None where it
    draws none."""
    shape = tuple(shape)
    with jax.enable_x64(True):
        if isinstance(comp, tc.RandK):
            out = _silo_draw("randk", shape, comp.k)(keys)
        elif isinstance(comp, tc.RandomDithering):
            out = _silo_draw("dithering", shape, None)(keys)
        elif isinstance(comp, tc.NaturalSparsification):
            out = _silo_draw("natural", shape, comp.p)(keys)
        elif isinstance(comp, tc.PowerSGD):
            out = powersgd_start(comp, shape[1])
        else:
            return None
        return _torch(out)


def powersgd_start(comp, d1: int):
    """The reference PowerSGD's start subspace (from its own seed)."""
    with jax.enable_x64(True):
        return jr.normal(jr.PRNGKey(comp.seed), (d1, comp.r), jnp.float64)


def _active(key, n: int, tau: int) -> torch.Tensor:
    perm = np.asarray(jr.permutation(key, n))
    mask = np.zeros(n, bool)
    mask[perm[:tau]] = True
    return torch.from_numpy(mask)


def subsample_draws(key, n: int, m: int, m_sub: int) -> torch.Tensor:
    """The (n, m_sub) data points the reference's subsampled Hessian
    oracle picks under ``key`` (tests/test_extensions.py's recipe)."""
    with jax.enable_x64(True):
        return _torch(_silo_draw("randk", (m,), m_sub)(jr.split(key, n)))


def schedule(method: str, key, rounds: int, *args, **kw) -> Replay:
    """A ``Replay`` of ``_items``' draws (cached for a seed ``key``)."""
    make = _seed_items if isinstance(key, int) else _items
    rep = Replay()
    for kind, value in make(method, key, rounds, *args, **kw):
        rep.push(kind, value)
    return rep


def _items(method: str, key, rounds: int, n: int, d: int, comp=None,
           comp_m=None, tau=None, p=None, m=None, m_sub=None, k=None,
           init: bool = True) -> list:
    """The (kind, draw) pairs of ``rounds`` rounds of the reference
    ``method``'s key schedule from ``key`` (a seed: ``PRNGKey(seed)``,
    as the reference's ``init``; or a mid-run state's key): ``comp`` on
    (d, d) for the FedNL family and on (d,) for the first-order
    baselines; ``comp_m`` the downlink's; ``tau`` the active count,
    ``p`` a Bernoulli probability; ``m``/``m_sub`` the subsampled
    Hessian's points and ``k`` NL1's. ``init``: the stochastic method's
    ``init`` draw (from the key unsplit) comes first."""
    items = []

    def silos(c, key_, shape):         # every silo's draw from split keys
        items.append(("silos", compressor_draws(c, jr.split(key_, n), shape)))

    def one(c, key_):                  # a downlink's draw, a stack of one
        items.append(("silos", compressor_draws(c, key_[None], (d,))))

    with jax.enable_x64(True):
        if isinstance(key, int):
            key = jr.PRNGKey(key)
        if method == "fednl-stoch" and init:
            items.append(("oracle", subsample_draws(key, n, m, m_sub)))
        for _ in range(rounds):
            if method in ("fednl", "fednl-cr", "fednl-ls"):
                key, sub = jr.split(key)
                silos(comp, sub, (d, d))
            elif method in ("fednl-pp", "fednl-cohort"):
                key, k_sel, k_comp = jr.split(key, 3)
                items.append(("active", _active(k_sel, n, tau)))
                silos(comp, k_comp, (d, d))
            elif method == "fednl-bc":
                key, k_comp, k_m, k_xi = jr.split(key, 4)
                silos(comp, k_comp, (d, d))
                one(comp_m, k_m)
                items.append(("coin", bool(jr.bernoulli(k_xi, p))))
            elif method == "fednl-stoch":
                key, k_h, k_c = jr.split(key, 3)
                items.append(("oracle", subsample_draws(k_h, n, m, m_sub)))
                silos(comp, k_c, (d, d))
            elif method == "fednl-ppbc":
                key, k_sel, k_comp, k_m = jr.split(key, 4)
                one(comp_m, k_m)
                items.append(("active", _active(k_sel, n, tau)))
                silos(comp, k_comp, (d, d))
            elif method == "diana":
                key, sub = jr.split(key)
                silos(comp, sub, (d,))
            elif method == "nl1":
                key, sub = jr.split(key)
                silos(tc.RandK(k), sub, (m,))
            elif method == "adiana":
                key, k1, k2, k3 = jr.split(key, 4)
                silos(comp, k1, (d,))
                silos(comp, k2, (d,))
                items.append(("coin", bool(jr.bernoulli(k3, p))))
            elif method == "dore":
                key, k_up, k_down = jr.split(key, 3)
                silos(comp, k_up, (d,))
                one(comp_m, k_down)
            elif method == "artemis":
                key, k_sel, k_up = jr.split(key, 3)
                items.append(("active", _active(k_sel, n, tau)))
                silos(comp, k_up, (d,))
            else:
                raise ValueError(method)
    return items


_seed_items = functools.lru_cache(maxsize=None)(_items)
