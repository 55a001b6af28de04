"""FedNL curvature learning for large models, counterpart of
``repro.second_order.fednl_precond``.

Per parameter tensor, H is a diagonal curvature estimate learned from
local observations D^k (the empirical Fisher g^2, or Hutchinson's
z * Hz) through FedNL's compressed rule

    H^{k+1} = H^k + alpha * C(D^k - H^k),     C = Block-Top-K,

with the Option-2 ridge l^k = ||D^k - H^k||_F / sqrt(numel) making the
step safe:

    u = -lr * m,   m = momentum * m + g / (sqrt(max(H^k, 0)) + sqrt(l^k) + eps).

Every tensor is partitioned into (block x block) tiles of its 2-D view
(``_shape2d``: leading axes collapse onto the rows). When observations
carry a leading silo axis, each silo's D_i - H goes through the fused
``diff_topk_payload`` kernel against the ONE shared H (read in place,
silo stride 0), and the server mean of the payloads comes from
``block_scatter_accumulate``: neither a per-silo dense difference nor a
per-silo copy of H is made. ``refresh`` (learn H and l) and
``precondition`` (the step from stored H and l) split the work so a
trainer can refresh every few steps; ``update`` does both per step, with
the pre-learning H and the current l, as the reference pins.

The kernels run where the tensors are: on a card the CUDA kernels, on
the CPU their plain versions. Each ``a + c * b`` of the reference is
``torch.add(a, b, alpha=c)``: one rounding, as XLA fuses it.
``uplink_bits`` is the wire cost of one refresh (``wire.wire_cost``'s
analytic count, from shapes alone), bound in the ``Optimizer`` adapter
as the reference binds it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..core.compressors import BlockSparsePayload, BlockTopKThreshold
from ..kernels.block_topk import diff_topk_payload
from ..tree import tree_leaves, tree_map
from .optim import Optimizer


class FedNLPrecondState(NamedTuple):
    step: int
    h: Any            # per-tensor diagonal curvature estimates (f32)
    mu: Any           # momentum on the preconditioned step (f32)
    l: Any = None     # per-tensor Option-2 ridge (0-d f32); None: unset


def _shape2d(shape) -> tuple:
    """Block-partition layout of a tensor: every leading axis collapses
    onto the rows, so a stacked per-layer param (n_seg, din, dout) tiles
    as (n_seg * din, dout); 1-D is one row, a scalar (1, 1)."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, int(shape[0]))
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    return (rows, int(shape[-1]))


def _pick(out, i: int):
    return tree_map(lambda t: t[i], out)


@dataclasses.dataclass(frozen=True)
class FedNLPrecondOptimizer:
    lr: float = 1e-3
    alpha: float = 1.0                 # Hessian learning rate
    k_per_block: int = 2048            # Block-Top-K sparsity (delta = k/b^2)
    block: int = 128
    momentum: float = 0.9
    eps: float = 1e-8
    weight_decay: float = 0.0
    curvature: str = "fisher"          # fisher | hutchinson

    def _k(self) -> int:
        return min(self.k_per_block, self.block * self.block)

    @property
    def compressor(self) -> BlockTopKThreshold:
        """The uplink's Block-Top-K codec: ``compress`` is a silo's wire
        payload (the ``block_topk_payload`` kernel, the same bisection
        as the fused uplink), ``aggregate`` the server mean, ``spec`` the
        Def 3.3 accounting."""
        return BlockTopKThreshold(k_per_block=self._k(), block=self.block)

    def init(self, params) -> FedNLPrecondState:
        def z32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return FedNLPrecondState(
            0, tree_map(z32, params), tree_map(z32, params),
            tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                           device=p.device), params))

    def observe(self, grads, params=None, hvp=None):
        """Local curvature observation D^k per tensor, in f32."""
        if self.curvature == "hutchinson":
            if hvp is None:
                raise ValueError(
                    "curvature='hutchinson' requires the hvp=(z, Hz) probe "
                    "(one Hessian-vector product per step); got hvp=None — "
                    "refusing to fall back to the Fisher diagonal")
            z, hz = hvp
            return tree_map(lambda zz, hh: zz.to(torch.float32)
                            * hh.to(torch.float32), z, hz)
        return tree_map(lambda g: g.to(torch.float32) * g.to(torch.float32),
                        grads)

    def _payload_mean(self, vals, idx, shape2) -> torch.Tensor:
        """Dense mean of n stacked silo payloads: one accumulator."""
        payloads = BlockSparsePayload(values=vals, indices=idx,
                                      universe=self.block * self.block)
        return self.compressor.aggregate(payloads, shape2)

    def _learn_tensor(self, h, d_obs):
        """One tensor's compressed learning: the increment s = C(D - H)
        (the server mean of per-silo payloads when ``d_obs`` carries a
        leading silo axis) and the ridge l. Returns (s, l)."""
        shape2 = _shape2d(h.shape)
        h2 = h.reshape(shape2)
        if d_obs.dim() == h.dim() + 1:
            obs = d_obs.to(torch.float32).reshape((d_obs.shape[0],) + shape2)
            vals, idx, sq = diff_topk_payload(obs, h2, self._k(), self.block)
            l = torch.mean(torch.sqrt(sq / h.numel() + 1e-30))
        else:
            vals, idx, sq = diff_topk_payload(d_obs.reshape((1,) + shape2),
                                              h2, self._k(), self.block)
            l = torch.sqrt(sq[0] / h.numel() + 1e-30)
        s = self._payload_mean(vals, idx, shape2).reshape(h.shape)
        return s, l

    def _precond_tensor(self, g, h, m, p, l):
        """The per-step preconditioned update from stored (h, l)."""
        g32 = g.to(torch.float32)
        denom = torch.sqrt(torch.clamp(h, min=0.0)) + torch.sqrt(l) + self.eps
        step = g32 / denom
        if self.weight_decay:
            step = torch.add(step, p.to(torch.float32),
                             alpha=self.weight_decay)
        m_new = torch.add(step, m, alpha=self.momentum)
        u = (-self.lr * m_new).to(p.dtype)
        return u, m_new

    def refresh(self, state: FedNLPrecondState,
                observations) -> FedNLPrecondState:
        """Learn curvature from (possibly silo-stacked) observations:
        new h and stored ridge l; step and mu untouched."""
        out = tree_map(self._learn_tensor, state.h, observations)
        s, l = _pick(out, 0), _pick(out, 1)
        h_new = tree_map(lambda h, si: torch.add(h, si, alpha=self.alpha),
                         state.h, s)
        return state._replace(h=h_new, l=l)

    def precondition(self, grads, state: FedNLPrecondState, params):
        """The step from the curvature stored by the last ``refresh``
        (zero ridge before the first one)."""
        l = state.l
        if l is None:
            l = tree_map(lambda h: torch.zeros((), dtype=torch.float32,
                                               device=h.device), state.h)
        out = tree_map(self._precond_tensor, grads, state.h, state.mu,
                       params, l)
        return _pick(out, 0), state._replace(step=state.step + 1,
                                             mu=_pick(out, 1))

    def uplink_bits(self, params, n_silos: int = 1) -> int:
        """Host-side wire cost of ONE curvature refresh: every silo ships
        one Block-Top-K diff payload per parameter tensor (``wire_cost``'s
        analytic count: k values and k indices per tile of the tensor's
        2-D block partition). Reads shapes only; call it at setup."""
        from ..wire.report import wire_cost

        total = 0
        for p in tree_leaves(params):
            rep = wire_cost(self.compressor, _shape2d(p.shape),
                            encoded=False)
            total += int(rep.analytic_bits)
        return total * int(n_silos)

    def update(self, grads, state: FedNLPrecondState, params,
               observations=None):
        """Learn and step at once. ``observations`` leaves may carry a
        leading silo axis; without them the Fisher diagonal of ``grads``
        is observed. The denominator uses the pre-learning h with the
        current observation's l."""
        obs = observations if observations is not None else self.observe(grads)

        def per_tensor(g, h, m, p, d_obs):
            s, l = self._learn_tensor(h, d_obs)
            u, m_new = self._precond_tensor(g, h, m, p, l)
            return u, torch.add(h, s, alpha=self.alpha), m_new, l

        out = tree_map(per_tensor, grads, state.h, state.mu, params, obs)
        return _pick(out, 0), FedNLPrecondState(
            state.step + 1, _pick(out, 1), _pick(out, 2), _pick(out, 3))


def fednl_precond(lr: float = 1e-3, **kw) -> Optimizer:
    """``Optimizer`` adapter: ``update`` is bound directly, so the optional
    ``observations`` reach it; the amortized hooks and the host-side
    ``uplink_bits`` ride along."""
    opt = FedNLPrecondOptimizer(lr=lr, **kw)
    return Optimizer(opt.init, opt.update, observe=opt.observe,
                     refresh=opt.refresh, precondition=opt.precondition,
                     uplink_bits=opt.uplink_bits)
