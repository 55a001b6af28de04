"""The ``MethodBase`` round driver, its uplink helpers and the method
registry (counterpart of ``repro.engine.method``).

A method is a config object with ``init(x0, n, ..., seed=0,
draws=None) -> State``, ``step(State) -> State`` and
``bits_per_round(d)``. ``MethodBase.run`` is the one round loop — a
Python loop where the reference has ``lax.scan`` — and the uplink is
split the way the deployment is: ``_uplink_diff_payloads`` and
``_local_hessians`` on the devices, ``_server_aggregate`` on the
server, which never sees a silo's dense matrix.

Where the reference keeps a PRNG key in its state and splits it every
round, a port method keeps a round-draw source (``RoundDraws`` by
default, from ``seed``; ``draws=`` gives another, such as one that
replays the reference's draws). Its methods hand a step the variates the
reference splits from its key: each silo's compressor draw, the active
set, a Bernoulli flag, an oracle's generator. ``bits_per_round`` is the
analytic count from ``comp.spec(shape).bits``;
``measured_bits_per_round`` the count measured from the payload's
structure (``wire.wire_cost``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class Oracles(NamedTuple):
    """value: x -> () global objective (None where unused);
    grad: x -> (n, d) per-silo gradients; hess: x -> (n, d, d)."""

    value: Optional[Callable[[torch.Tensor], torch.Tensor]]
    grad: Callable[[torch.Tensor], torch.Tensor]
    hess: Callable[[torch.Tensor], torch.Tensor]


class RoundDraws:
    """The default round-draw source: one CPU ``torch.Generator`` seeded
    with ``seed``, each draw moved to ``device``. Drawing on the CPU
    gives a run on the card and a run on the CPU from one seed the same
    draws."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.gen = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)

    def silos(self, comp, n: int, shape, dtype):
        """n silos' stacked draws for ``comp`` at ``shape``; None for a
        deterministic compressor."""
        draw = comp.draw(n, tuple(shape), dtype, self.gen)
        return None if draw is None else draw.to(self.device)

    def active(self, n: int, tau: int) -> torch.Tensor:
        """(n,) bool mask of tau silos, a uniform subset."""
        mask = torch.zeros(n, dtype=torch.bool)
        mask[torch.randperm(n, generator=self.gen)[:tau]] = True
        return mask.to(self.device)

    def coin(self, p: float) -> bool:
        """One Bernoulli(p) flag, on the host."""
        return bool(torch.rand((), generator=self.gen,
                               dtype=torch.float64) < p)

    def oracle(self, fn):
        """Stochastic oracle ``fn``'s draw (``fn.draw``); None if it
        draws nothing."""
        draw = fn.draw(self.gen)
        return None if draw is None else draw.to(self.device)


def round_draws(draws, seed: int, x0: torch.Tensor):
    """``draws`` if given, else ``RoundDraws(seed)`` on x0's device."""
    return RoundDraws(seed, x0.device) if draws is None else draws


def payload_wire_bits(comp, shape, index_coding: str = "raw",
                      dtype: torch.dtype = torch.float64) -> int:
    """One payload's measured bits at ``shape``: ``wire_cost``'s raw or
    entropy count."""
    from ..wire.report import wire_cost

    rep = wire_cost(comp, shape, dtype=dtype, encoded=False)
    return rep.entropy_bits if index_coding == "entropy" else rep.raw_bits


class MethodBase:
    """Shared ``run`` driver plus the payload wire helpers."""

    traj_field: str = "x"

    def _uplink_diff_payloads(self, h_new, h_old, silo_draws=None):
        """Device side: payloads of D_i = h_new_i - h_old_i and
        l_i = ||D_i||_F. Compressors with ``fused_diff_payloads`` (the
        block-sparse family) do both in one kernel pass; the others
        compress the dense difference with this round's ``silo_draws``
        (which the fused path, deterministic, ignores)."""
        fused = getattr(self.comp, "fused_diff_payloads", None)
        if fused is not None:
            return fused(h_new, h_old)
        from ..core.linalg import frob_norm

        diff = h_new - h_old
        return self.comp.apply(diff, silo_draws), frob_norm(diff)

    def _local_hessians(self, payloads, shape):
        """Device side: each silo's own dense S_i, for its H_i update."""
        return self.comp.decompress(payloads, shape)

    def _server_aggregate(self, payloads, shape, weights=None):
        """Server side: S = mean_i w_i S_i straight from payload space;
        ``weights`` (0 for an absent silo) scale the payloads."""
        return self.comp.aggregate(payloads, shape, weights=weights)

    def measured_bits_per_round(self, d: int, index_coding: str = "raw",
                                dtype: torch.dtype = torch.float64):
        """MEASURED per-round wire bits: the compressor's payload structure
        (``wire_cost``, no compute) plus the (d + 1) uncompressed floats
        of ``dtype`` every single-uplink FedNL variant ships (a gradient-
        sized vector and one scalar). ``index_coding="entropy"`` charges
        the index streams ceil(log2 C(d^2, k)). Methods with another
        layout (FedNL-BC, FedNL-PP-BC) override; a method without a
        compressor returns its analytic count, its wire being dense
        floats."""
        comp = getattr(self, "comp", None)
        if comp is None:
            return self.bits_per_round(d)
        from ..core.compressors import canonical_float_bits

        return (payload_wire_bits(comp, (d, d), index_coding, dtype)
                + (d + 1) * canonical_float_bits(dtype))

    def run(self, x0, n, num_rounds: int, *args, seed: int = 0, **init_kw):
        """``num_rounds`` rounds from x0. Returns (final state,
        (num_rounds + 1, d) iterates with x0 first); extra arguments go
        to ``init``."""
        state = self.init(x0, n, *args, seed=seed, **init_kw)
        xs = [x0]
        for _ in range(num_rounds):
            state = self.step(state)
            xs.append(getattr(state, self.traj_field))
        return state, torch.stack(xs)


# -- registry -----------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(name: str):
    """Decorator: register ``factory(oracles, compressor=None, **params)``."""

    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def _ensure_registered() -> None:
    # factories live beside their classes in ``core``, which imports
    # this module for MethodBase: import lazily to avoid the cycle
    from .. import core  # noqa: F401


def available_methods() -> list[str]:
    _ensure_registered()
    return sorted(_REGISTRY)


def make_method(name: str, oracles: Oracles, compressor=None, **params):
    """Construct a registered method by name; ``params`` (alpha, option,
    mu, tau, p, l_star, model_compressor, cohort, ...) go to its factory.
    A compressor param given as a tuple, ``model_compressor=("topk",
    16)``, is built through the compressor registry."""
    _ensure_registered()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown method {name!r}; available: "
                       f"{available_methods()}") from None
    from ..core.compressors import make_compressor

    params = {k: make_compressor(*v) if k.endswith("compressor")
              and isinstance(v, tuple) else v for k, v in params.items()}
    return factory(oracles, compressor, **params)
