"""The ``MethodBase`` round driver, its uplink helpers and the method
registry (counterpart of ``repro.engine.method``).

A method is a config object with ``init(x0, n, ...) -> State``,
``step(State) -> State`` and ``bits_per_round(d)``. ``MethodBase.run``
is the one round loop — a Python loop where the reference has
``lax.scan`` — and the uplink is split the way the deployment is:
``_uplink_diff_payloads`` and ``_local_hessians`` on the devices,
``_server_aggregate`` on the server, which never sees a silo's dense
matrix.
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


class MethodBase:
    """Shared ``run`` driver plus the payload wire helpers."""

    traj_field: str = "x"

    def _uplink_diff_payloads(self, h_new, h_old):
        """Device side: payloads of D_i = h_new_i - h_old_i and
        l_i = ||D_i||_F. Compressors with ``fused_diff_payloads`` (the
        block-sparse family) do both in one kernel pass; the others
        compress the dense difference."""
        fused = getattr(self.comp, "fused_diff_payloads", None)
        if fused is not None:
            return fused(h_new, h_old)
        from ..core.linalg import frob_norm

        diff = h_new - h_old
        return self.comp.compress(diff), frob_norm(diff)

    def _local_hessians(self, payloads, shape):
        """Device side: each silo's own dense S_i, for its H_i update."""
        return self.comp.decompress(payloads, shape)

    def _server_aggregate(self, payloads, shape):
        """Server side: S = mean_i S_i straight from payload space."""
        return self.comp.aggregate(payloads, shape)

    def run(self, x0, n, num_rounds: int, *args, **init_kw):
        """``num_rounds`` rounds from x0. Returns (final state,
        (num_rounds + 1, d) iterates with x0 first); extra arguments go
        to ``init``."""
        state = self.init(x0, n, *args, **init_kw)
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
    mu, ...) go to its factory."""
    _ensure_registered()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown method {name!r}; available: "
                       f"{available_methods()}") from None
    return factory(oracles, compressor, **params)
