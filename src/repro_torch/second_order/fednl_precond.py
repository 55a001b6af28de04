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
as the reference binds it. On a mesh (``launch.steps.make_train_step``
with ``mesh``), H and the momentum are laid out over the ranks, each
index of the "data" axis plays one silo, and ``refresh`` takes the
layout: per tensor, H is gathered whole over "data" for K1, the silos'
payloads cross the data ranks as the uplink before K4, and each rank
keeps its own shard of the increment. A tensor split over "model" runs
K1 and K4 on this rank's model shard where the split falls on tile
bounds (``_tile_grid``), its per-tile ridge terms gathered into the
whole tensor's tile order; elsewhere the tensor is gathered whole over
"model" first. The train step on a mesh hands ``refresh_grads`` its
silos' gradients instead of their observations: leaf by leaf, each is
squared in f32, learned and dropped, and a stacked leaf split over
"data" whose layers lie on tile bounds goes a layer slice at a time (H's
slice gathered over "data" for K1, the slice's payloads over the ranks
for K4), so neither a tree of observations nor a leaf's whole H is held.
``donate`` lets ``refresh`` and ``precondition`` write H and the
momentum in place (the caller drops the old state), with the same
arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..core.compressors import BlockSparsePayload, BlockTopKThreshold
from ..kernels.block_topk import diff_topk_payload
from ..tree import tree_leaves, tree_map, tree_unflatten
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


def _tile_grid(shape, dim: int, block: int):
    """(grid, axis): the (block x block) tiles of a rank's shard of a
    tensor split on ``dim`` as a grid whose ``axis`` is the split's, such
    that the ranks' grids concatenated on ``axis`` are the whole tensor's
    tiles in their row-major order; None where a tile would straddle two
    ranks' shards (the split is not on tile bounds)."""
    shape = tuple(int(x) for x in shape)
    if not shape:
        return None
    rows = 1
    for x in shape[:-1]:
        rows *= x
    cols_t = -(-shape[-1] // block)
    if dim == len(shape) - 1:
        if shape[-1] % block:
            return None
        return (-(-rows // block), shape[-1] // block), 1
    pre = mid = 1
    for x in shape[:dim]:
        pre *= x
    for x in shape[dim:-1]:
        mid *= x
    if mid % block:
        return None
    return (pre, mid // block, cols_t), 1


def _model_tiles(model, grid: tuple, axis: int):
    """The ``tiles`` hook of ``learn`` for a shard on ``_tile_grid``'s
    ``(grid, axis)``: the (silos, tiles) terms of every model rank's
    shard gathered into the whole tensor's tile order."""
    def tiles(sq):
        n = sq.shape[0]
        return model.whole(sq.reshape((n,) + grid), axis + 1).reshape(n, -1)

    return tiles


def _ridge(tile_sq: torch.Tensor, numel: int, stacked: bool = True):
    """The Option-2 ridge from the (silos, tiles) terms of ||D_i - H||^2:
    each silo's sum in one reduction over the stack, then the mean over
    the silos of sqrt(sum / numel) (one silo's own without a stack)."""
    sq = torch.sum(tile_sq, dim=1)
    if stacked:
        return torch.mean(torch.sqrt(sq / numel + 1e-30))
    return torch.sqrt(sq[0] / numel + 1e-30)


def _whole_grad(g) -> torch.Tensor:
    """A silo's gradient of one leaf as ``launch.steps.silo_gradients``
    gives it (a tensor, or its layers' list), whole."""
    return torch.stack(g) if isinstance(g, list) else g


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

    def learn(self, h, d_obs, gather=None, tiles=None, numel=None):
        """One tensor's compressed learning: the increment s = C(D - H)
        (the server mean of per-silo payloads when ``d_obs`` carries a
        leading silo axis) and the ridge l. Returns (s, l).

        ``gather`` maps this call's payload (values, indices and the
        per-tile ||D_i - H||^2 terms, each on a leading silo axis) to
        every silo's, stacked in silo order: on a mesh, each rank's
        silos cross the ranks there as a payload before the server
        mean. The ridge sums each silo's terms in one reduction over the
        stack, so a silo's l does not depend on which call made it.
        ``tiles`` maps the (silos, tiles) terms of a shard ``h`` of a
        larger tensor (``numel`` elements) to the whole tensor's, in its
        tile order, so that l is the whole tensor's bit for bit."""
        shape2 = _shape2d(h.shape)
        h2 = h.reshape(shape2)
        stacked = d_obs.dim() == h.dim() + 1
        obs = (d_obs.to(torch.float32).reshape((d_obs.shape[0],) + shape2)
               if stacked else d_obs.reshape((1,) + shape2))
        vals, idx, tile_sq = diff_topk_payload(obs, h2, self._k(), self.block,
                                               tile_sums=True)
        if gather is not None:
            vals, idx, tile_sq = gather(vals, idx, tile_sq)
        if tiles is not None:
            tile_sq = tiles(tile_sq)
        l = _ridge(tile_sq, h.numel() if numel is None else numel, stacked)
        s = self._payload_mean(vals, idx, shape2).reshape(h.shape)
        return s, l

    def _learn_laid_out(self, h, d_obs, lay=None):
        """``learn`` of a rank's shard ``h`` of a tensor laid out by
        ``lay`` (``launch.sharding.LeafLayout``): H gathered whole over
        "data" for K1, the silos' payloads gathered for K4, and this
        rank's shard of s kept. Over "model": K1 and K4 on this rank's
        model shard where the split is on tile bounds, else on the tensor
        gathered whole over "model" too. ``lay`` None: ``h`` is the whole
        tensor. ``d_obs`` is this rank's silos' observations, whole over
        "data" and this rank's over "model"."""
        if lay is None:
            return self.learn(h, d_obs)
        h = lay.whole(h)
        model, mdim = lay.model, lay.mdim
        if mdim is None or model.world == 1:
            s, l = self.learn(h, d_obs, gather=lay.axis.gather)
            return lay.part(s), l
        tiled = _tile_grid(h.shape, mdim, self.block)
        if tiled is not None:
            s, l = self.learn(h, d_obs, gather=lay.axis.gather,
                              tiles=_model_tiles(model, *tiled),
                              numel=h.numel() * model.world)
            return lay.part(s), l
        lead = d_obs.dim() - h.dim()
        s, l = self.learn(model.whole(h, mdim),
                          model.whole(d_obs, mdim + lead),
                          gather=lay.axis.gather)
        return lay.part(model.part(s, mdim)), l

    def _by_layer(self, h, lay):
        """The layer-by-layer route's whole-over-"data" shape of a rank's
        shard ``h`` and its model-tile hook (None where not split over
        "model"), or None where the route does not apply: a leaf not
        split over "data" (its H is not gathered, and K1 takes the rank's
        tensor in one launch), fewer than 3 dims, a leading dim that is
        split, a layer's rows off the 128-row tile bounds (its tiles
        would not be the whole tensor's in order), or a "model" split off
        them (the tensor is gathered over "model")."""
        if (lay is None or lay.dim is None or lay.axis.world == 1
                or h.dim() < 3 or 0 in (lay.dim, lay.mdim)):
            return None
        shape = list(h.shape)
        shape[lay.dim] *= lay.axis.world
        rows = 1
        for x in shape[1:-1]:
            rows *= x
        if rows % self.block:
            return None
        if lay.mdim is None or lay.model.world == 1:
            return shape, None
        tiled = _tile_grid(shape, lay.mdim, self.block)
        return None if tiled is None else (shape, _model_tiles(lay.model,
                                                               *tiled))

    def _learn_grads(self, h, grads: list, lay, donate: bool = False):
        """H after the refresh and l of one leaf from this rank's silos'
        gradients of it (``refresh_grads``). Where ``_by_layer`` holds, a
        layer slice at a time: H's slice gathered over "data", the silos'
        g^2 of it, K1, the payloads gathered over the data ranks, K4, and
        this rank's shard of the slice's increment added, the per-tile
        terms kept in the tensor's tile order for the ridge. Elsewhere
        the leaf's observations whole, through ``_learn_laid_out``."""
        route = self._by_layer(h, lay)
        if route is None:
            obs = torch.stack([self.observe(_whole_grad(g)) for g in grads])
            s, l = self._learn_laid_out(h, obs, lay)
            del obs
            return (h.add_(s, alpha=self.alpha) if donate
                    else torch.add(h, s, alpha=self.alpha)), l
        shape, tiles = route
        sub = type(lay)(lay.dim - 1, lay.axis,
                        None if lay.mdim is None else lay.mdim - 1)
        out = h if donate else torch.empty_like(h)
        sqs = []
        for i in range(h.shape[0]):
            hi = sub.whole(h[i])
            shape2 = _shape2d(hi.shape)
            obs = torch.stack([self.observe(g[i]) for g in grads])
            vals, idx, sq = diff_topk_payload(
                obs.reshape((obs.shape[0],) + shape2), hi.reshape(shape2),
                self._k(), self.block, tile_sums=True)
            del obs, hi
            vals, idx, sq = lay.axis.gather(vals, idx, sq)
            s = sub.part(self._payload_mean(vals, idx, shape2).reshape(
                shape[1:]))
            del vals, idx
            torch.add(h[i], s, alpha=self.alpha, out=out[i])
            sqs.append(sq)
            del s
        tile_sq = torch.cat(sqs, dim=1)
        numel = 1
        for x in shape:
            numel *= x
        if tiles is not None:
            tile_sq, numel = tiles(tile_sq), numel * lay.model.world
        return out, _ridge(tile_sq, numel)

    def refresh_grads(self, state: FedNLPrecondState, grads: list, layout,
                      donate: bool = False) -> FedNLPrecondState:
        """``refresh`` on a mesh from this rank's silos' gradients, not
        their observations (Fisher curvature): ``grads`` holds a list a
        local silo, one entry a leaf in ``tree_leaves`` order as
        ``launch.steps.silo_gradients`` gives it (whole over "data", this
        rank's over "model"; a stacked leaf split over "data" as its
        layers' list). Leaf by leaf, each silo's gradient is squared in
        f32, learned and dropped (``_learn_grads``), so no tree of
        observations is held. H and l equal ``refresh``'s of the same
        gradients' observations bit for bit."""
        hs = tree_leaves(state.h)
        lays = tree_leaves(layout)
        h_new, ls = [], []
        for j, (h, lay) in enumerate(zip(hs, lays)):
            mine = [silo[j] for silo in grads]
            for silo in grads:
                silo[j] = None
            hj, l = self._learn_grads(h, mine, lay, donate)
            del mine
            h_new.append(hj)
            ls.append(l)
        return state._replace(h=tree_unflatten(state.h, h_new),
                              l=tree_unflatten(state.h, ls))

    def _precond_tensor(self, g, h, m, p, l, donate: bool = False):
        """The per-step preconditioned update from stored (h, l); with
        ``donate`` the new momentum is written over ``m``."""
        # g / (sqrt(max(h, 0)) + sqrt(l) + eps), its operations in that
        # order, in one temporary the size of the tensor
        step = torch.clamp(h, min=0.0).sqrt_().add_(torch.sqrt(l))
        step = torch.div(g.to(torch.float32), step.add_(self.eps), out=step)
        if self.weight_decay:
            step = torch.add(step, p.to(torch.float32),
                             alpha=self.weight_decay)
        if donate:
            m_new = torch.add(step, m, alpha=self.momentum, out=m)
        else:
            m_new = torch.add(step, m, alpha=self.momentum)
        del step
        u = (-self.lr * m_new).to(p.dtype)
        return u, m_new

    def refresh(self, state: FedNLPrecondState, observations,
                layout=None, donate: bool = False) -> FedNLPrecondState:
        """Learn curvature from (possibly silo-stacked) observations:
        new h and stored ridge l; step and mu untouched. ``layout`` (a
        tree like ``state.h`` of ``LeafLayout``s) says how each H is laid
        out over the ranks of a mesh when ``state.h`` holds this rank's
        shards and ``observations`` this rank's silos; None: one process
        holds every tensor and every silo. Tensor by tensor, so one
        increment is alive at a time; ``donate`` adds it into H in
        place."""
        hs = tree_leaves(state.h)
        obs = tree_leaves(observations)
        lays = [None] * len(hs) if layout is None else tree_leaves(layout)
        h_new, ls = [], []
        for h, o, lay in zip(hs, obs, lays):
            s, l = self._learn_laid_out(h, o, lay)
            h_new.append(h.add_(s, alpha=self.alpha) if donate
                         else torch.add(h, s, alpha=self.alpha))
            ls.append(l)
            del s
        return state._replace(h=tree_unflatten(state.h, h_new),
                              l=tree_unflatten(state.h, ls))

    def precondition(self, grads, state: FedNLPrecondState, params,
                     donate: bool = False):
        """The step from the curvature stored by the last ``refresh``
        (zero ridge before the first one); ``donate`` writes the momentum
        in place."""
        l = state.l
        if l is None:
            l = tree_map(lambda h: torch.zeros((), dtype=torch.float32,
                                               device=h.device), state.h)
        out = tree_map(lambda g, h, m, p, li: self._precond_tensor(
            g, h, m, p, li, donate), grads, state.h, state.mu, params, l)
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
            s, l = self.learn(h, d_obs)
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
                     uplink_bits=opt.uplink_bits,
                     refresh_grads=opt.refresh_grads)
