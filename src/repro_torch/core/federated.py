"""FedNL over a ``torch.distributed`` process group, counterpart of
``src/repro/core/federated.py``.

The paper's devices -> server -> devices pattern maps to:

* the silo axis of the data split over a mesh axis (default "data"):
  each rank holds only its silos' (a, b) slabs and Hessian estimates
  H_i, and computes on them alone;
* "send the compressed update to the server" = the rank's payload-space
  mean, then ``all_reduce`` (SUM) over the group divided by its size,
  the reference's ``pmean`` of the dense (d, d) accumulator;
* "broadcast x^{k+1}" = the same reduced values on every rank, so every
  rank computes the same x.

Draws stay the port's own: every rank takes each round's draws for all
n silos from the one seeded round-draw source and keeps its own silos'
slice, so a randomized compressor draws the same sharded and unsharded
(the reference folds the device index into its silo keys instead).
"""

from __future__ import annotations

import torch

from ..engine.method import round_draws
from .compressors import Compressor
from .fednl import FedNL, FedNLState
from .objectives import LogRegData, batch_grad, batch_hess


class ShardDraws:
    """A round-draw source seen by one rank: each round's draws are made
    for all ``n`` silos, and silos [lo, lo + count) are kept."""

    def __init__(self, base, n: int, lo: int):
        self.base, self.n, self.lo = base, int(n), int(lo)

    def silos(self, comp, n: int, shape, dtype):
        draw = self.base.silos(comp, self.n, shape, dtype)
        return None if draw is None else draw[self.lo:self.lo + n]


def run_fednl_sharded(data: LogRegData, compressor: Compressor, mesh,
                      x0: torch.Tensor, num_rounds: int, alpha: float = 1.0,
                      option: int = 2, mu: float = 0.0, axis: str = "data",
                      seed: int = 0, draws=None):
    """FedNL with the silos split over ``mesh[axis]`` (a ``DeviceMesh``;
    its extent must divide n). Returns (final state, this rank's silos
    in ``h_local``; (num_rounds + 1, d) iterates with x0 first).
    ``draws`` replaces the round-draw source ``RoundDraws(seed)``."""
    n = int(data.a.shape[0])
    world = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % world:
        raise ValueError(f"{n} silos do not split over {world} ranks")
    per = n // world
    lo = mesh.get_local_rank(axis) * per

    # the global init (exact local Hessians at x0), then this rank's slice
    h0 = batch_hess(x0, data)
    local = LogRegData(a=data.a[lo:lo + per].contiguous(),
                       b=data.b[lo:lo + per].contiguous(), lam=data.lam)
    alg = FedNL(lambda x: batch_grad(x, local),
                lambda x: batch_hess(x, local), compressor, alpha=alpha,
                option=option, mu=mu, group=mesh.get_group(axis))
    state = FedNLState(x=x0, h_local=h0[lo:lo + per].contiguous(),
                       h_global=torch.mean(h0, dim=0), step=0,
                       draws=ShardDraws(round_draws(draws, seed, x0), n, lo))
    del h0
    xs = [x0]
    for _ in range(num_rounds):
        state = alg.step(state)
        xs.append(state.x)
    return state, torch.stack(xs)
