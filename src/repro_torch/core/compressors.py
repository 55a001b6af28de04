"""Compression operators for FedNL (Definitions 3.2 and 3.3) as wire
codecs — the slice of ``repro.core.compressors`` that Algorithm 1 runs.

Every compressor works on a STACK of silo matrices: the silo axis that
the reference vmaps over is the leading dimension here.

    payload = comp.compress(m)                # m: (n, *shape)
    dense   = comp.decompress(payload, shape) # (n, *shape)
    mean    = comp.aggregate(payload, shape)  # (*shape) server mean

The server never decompresses a silo: ``aggregate`` sums the stacked
payloads straight into one dense accumulator — the ``scatter_accum``
kernels for the sparse families, one factor contraction for Rank-R.
Top-K selection breaks ties toward the lower flat index, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` does
not promise that order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.block_topk import (
    block_topk_payload,
    diff_topk_payload,
    from_tiles,
    to_tiles,
)
from ..kernels.scatter_accum import block_scatter_accumulate, scatter_accumulate

FLOAT_BITS = 64  # the paper counts double-precision floats
INDEX_BITS = 32


def numel(shape) -> int:
    return math.prod(int(s) for s in shape)


# ---------------------------------------------------------------------------
# Payloads — the wire objects, stacked over silos
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparsePayload:
    """k (value, flat-index) pairs per silo; -1 marks an empty slot.
    ``universe`` is the number of addressable slots."""

    values: torch.Tensor   # (n, k)
    indices: torch.Tensor  # (n, k) int32
    universe: int = 0


@dataclasses.dataclass(frozen=True)
class BlockSparsePayload:
    """k (value, in-tile flat index) pairs per (block x block) tile,
    tiles in row-major grid order; ``universe`` is block^2."""

    values: torch.Tensor   # (n, tiles, k)
    indices: torch.Tensor  # (n, tiles, k) int32
    universe: int = 0


@dataclasses.dataclass(frozen=True)
class LowRankPayload:
    """Rank-R factors: dense = (left * middle) @ right^T."""

    left: torch.Tensor    # (n, d0, r)
    right: torch.Tensor   # (n, d1, r)
    middle: torch.Tensor  # (n, r)


@dataclasses.dataclass(frozen=True)
class DensePayload:
    """A dense array shipped as-is; ``count`` entries on the wire."""

    values: torch.Tensor
    count: int = 0


def _scatter_flat(values: torch.Tensor, indices: torch.Tensor,
                  size: int) -> torch.Tensor:
    """(n, size) rows from (n, k) (value, index) pairs; indices outside
    [0, size) — the -1 padding — are dropped."""
    n = values.shape[0]
    idx = indices.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros((n, size + 1), dtype=values.dtype, device=values.device)
    out.scatter_(1, idx, values)
    return out[:, :size]


def scale_payload(payload, w: torch.Tensor):
    """Payload whose decoded matrices are w_i * decompress(payload_i):
    the one leaf each format is linear in (values; low-rank middle)."""
    field = "middle" if isinstance(payload, LowRankPayload) else "values"
    leaf = getattr(payload, field)
    w = torch.as_tensor(w, dtype=leaf.dtype, device=leaf.device)
    wb = w.reshape(w.shape + (1,) * (leaf.dim() - w.dim()))
    return dataclasses.replace(payload, **{field: leaf * wb})


def _sparse_aggregate(payloads: SparsePayload, shape,
                      symmetric: bool = False) -> torch.Tensor:
    """mean_i of stacked SparsePayloads through one dense accumulator
    (``scatter_accumulate``); ``symmetric`` mirrors lower-triangular
    payloads in the same pass."""
    n = payloads.values.shape[0]
    shape2 = tuple(int(s) for s in shape)
    if len(shape2) != 2:
        shape2 = (1, numel(shape))
        symmetric = False
    total = scatter_accumulate(payloads.values, payloads.indices, shape2,
                               symmetric=symmetric)
    return (total / n).reshape(tuple(shape))


def _lowrank_aggregate(payloads: LowRankPayload) -> torch.Tensor:
    """mean_i (left_i * middle_i) @ right_i^T as one contraction over
    (silo, rank)."""
    left, right, mid = payloads.left, payloads.right, payloads.middle
    n = left.shape[0]
    return torch.einsum("nir,njr->ij", left * mid[:, None, :], right) / n


# ---------------------------------------------------------------------------
# CompSpec and the base class
# ---------------------------------------------------------------------------


class CompSpec(NamedTuple):
    """Analytic class parameters at a shape: exactly one of delta
    (Def 3.3) / omega (Def 3.2) is set; ``bits`` is the paper's uplink
    size; ``deterministic`` selects Assumption 3.4 vs 3.5."""

    delta: Optional[float]
    omega: Optional[float]
    bits: int
    deterministic: bool


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A compression operator on a silo stack; ``__call__`` is always
    ``decompress(compress(m))``."""

    def compress(self, m: torch.Tensor):
        raise NotImplementedError

    def decompress(self, payload, shape) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, m: torch.Tensor) -> torch.Tensor:
        return self.decompress(self.compress(m), m.shape[1:])

    def aggregate(self, payloads, shape, weights=None) -> torch.Tensor:
        """Server mean over silos, ``mean_i w_i * decompress(payload_i)``.
        This decompresses, which only a dense wire (``Identity``) may do;
        the other families override it with sums that never form the
        (n, *shape) stack."""
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return torch.mean(self.decompress(payloads, shape), dim=0)

    def spec(self, shape) -> CompSpec:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Compressor]] = {}


def _canon(name: str) -> str:
    return name.replace("-", "").replace("_", "").lower()


def register_compressor(*names: str):
    """Decorator: register ``factory(level) -> Compressor`` under every
    name (spelling-insensitive)."""

    def deco(factory):
        for n in names:
            _REGISTRY[_canon(n)] = factory
        return factory

    return deco


def available_compressors() -> list[str]:
    return sorted(_REGISTRY)


def make_compressor(family: str, level=None) -> Compressor:
    """("rankr", 1) -> RankR(1), etc."""
    fam = _canon(family)
    if fam not in _REGISTRY:
        raise ValueError(f"unknown compressor family {family!r}; "
                         f"known: {available_compressors()}")
    return _REGISTRY[fam](level)


# ---------------------------------------------------------------------------
# Contractive compressors  C(delta)  — Def 3.3
# ---------------------------------------------------------------------------


def _topk_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, ties to the lower index
    (the order ``jax.lax.top_k`` returns)."""
    return torch.sort(mag, dim=-1, descending=True, stable=True)[1][..., :k]


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Global Top-K (paper A.3.3), delta = K / numel. ``symmetric``
    compresses the lower triangle and mirrors it; K then counts
    lower-triangular entries."""

    k: int
    symmetric: bool = False

    def _sym(self, shape) -> bool:
        return self.symmetric and len(shape) == 2 and shape[0] == shape[1]

    def _slots(self, shape) -> int:
        if self._sym(shape):
            return shape[0] * (shape[0] + 1) // 2
        return numel(shape)

    def compress(self, m: torch.Tensor) -> SparsePayload:
        shape = tuple(m.shape[1:])
        n = m.shape[0]
        flat = (torch.tril(m) if self._sym(shape) else m).reshape(n, -1)
        k = min(self.k, self._slots(shape))
        idx = _topk_indices(torch.abs(flat), k)
        return SparsePayload(values=torch.gather(flat, 1, idx),
                             indices=idx.to(torch.int32),
                             universe=self._slots(shape))

    def decompress(self, payload: SparsePayload, shape) -> torch.Tensor:
        n = payload.values.shape[0]
        c = _scatter_flat(payload.values, payload.indices,
                          numel(shape)).reshape((n, *shape))
        if self._sym(tuple(shape)):
            return c + c.transpose(1, 2) - torch.diag_embed(
                torch.diagonal(c, dim1=1, dim2=2))
        return c

    def aggregate(self, payloads: SparsePayload, shape,
                  weights=None) -> torch.Tensor:
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return _sparse_aggregate(payloads, shape,
                                 symmetric=self._sym(tuple(shape)))

    def spec(self, shape) -> CompSpec:
        slots = self._slots(shape)
        k = min(self.k, slots)
        return CompSpec(delta=k / slots, omega=None,
                        bits=k * (FLOAT_BITS + INDEX_BITS),
                        deterministic=True)


@dataclasses.dataclass(frozen=True)
class _BlockSparse(Compressor):
    """Decode and accounting of the block-local Top-K family: per tile,
    (value, in-tile flat index) pairs in row-major grid order."""

    k_per_block: int
    block: int = 128

    def _k(self) -> int:
        return min(self.k_per_block, self.block * self.block)

    def decompress(self, payload: BlockSparsePayload, shape) -> torch.Tensor:
        b = self.block
        n, nblk, k = payload.values.shape
        tiles = _scatter_flat(payload.values.reshape(n * nblk, k),
                              payload.indices.reshape(n * nblk, k), b * b)
        return from_tiles(tiles.reshape(n, nblk, b * b), shape, b)

    def aggregate(self, payloads: BlockSparsePayload, shape,
                  weights=None) -> torch.Tensor:
        """Per-tile sum of all silos' pairs (``block_scatter_accumulate``),
        cropped, over n."""
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        b = self.block
        n = payloads.values.shape[0]
        gm, gn = -(-int(shape[0]) // b), -(-int(shape[1]) // b)
        total = block_scatter_accumulate(payloads.values, payloads.indices,
                                         (gm, gn), b)
        return total[:shape[0], :shape[1]] / n

    def spec(self, shape) -> CompSpec:
        b = self.block
        nblk = -(-shape[0] // b) * -(-shape[1] // b)
        return CompSpec(delta=self._k() / (b * b), omega=None,
                        bits=nblk * self._k() * (FLOAT_BITS + INDEX_BITS),
                        deterministic=True)

    def fused_diff_payloads(self, h_new: torch.Tensor, h_old: torch.Tensor):
        """Per silo, the payload of D_i = h_new_i - h_old_i and ||D_i||_F
        from one pass of the fused kernel (``diff_topk_payload``): the
        dense difference never reaches device memory. Within the f32
        bisection bracket, ties are kept in flat order."""
        vals, idx, sq = diff_topk_payload(h_new, h_old, k=self._k(),
                                          block=self.block)
        payloads = BlockSparsePayload(values=vals, indices=idx,
                                      universe=self.block * self.block)
        return payloads, torch.sqrt(sq)


@dataclasses.dataclass(frozen=True)
class BlockTopK(_BlockSparse):
    """Block-local Top-K: the top ``k_per_block`` entries of every
    (b x b) tile, delta = k_per_block / b^2. ``compress`` is the
    sort-based selection; the FedNL uplink uses ``fused_diff_payloads``."""

    def compress(self, m: torch.Tensor) -> BlockSparsePayload:
        tiles = to_tiles(m, self.block)
        idx = _topk_indices(torch.abs(tiles), self._k())
        return BlockSparsePayload(values=torch.gather(tiles, 2, idx),
                                  indices=idx.to(torch.int32),
                                  universe=self.block * self.block)


@dataclasses.dataclass(frozen=True)
class BlockTopKThreshold(_BlockSparse):
    """Block-local Top-K by threshold bisection: per tile, 32 rounds of
    an f32 bracket of the k-th |x|, then exactly k entries — every entry
    above the bracket, then bracket ties in flat order — so Def 3.3
    holds at delta = k_per_block / b^2 even inside a tie cluster.
    ``compress`` is the ``block_topk_payload`` kernel, bracketing also
    when k covers the tile, as the reference class does."""

    def compress(self, m: torch.Tensor) -> BlockSparsePayload:
        vals, idx = block_topk_payload(m, self._k(), self.block,
                                       bisect_all=True)
        return BlockSparsePayload(values=vals, indices=idx,
                                  universe=self.block * self.block)


@dataclasses.dataclass(frozen=True)
class RankR(Compressor):
    """Rank-R truncation (paper A.3.2), delta = R/d. ``symmetric``
    (default: FedNL compresses Hessian differences) keeps the R
    largest-|lambda| eigenpairs of the symmetrized matrix; otherwise the
    top R singular triplets."""

    r: int
    symmetric: bool = True

    def compress(self, m: torch.Tensor) -> LowRankPayload:
        if self.symmetric:
            lam, q = torch.linalg.eigh(0.5 * (m + m.transpose(1, 2)))
            idx = _topk_indices(torch.abs(lam), min(self.r, lam.shape[-1]))
            vecs = torch.gather(q, 2, idx.unsqueeze(1).expand(
                -1, q.shape[1], -1))
            return LowRankPayload(left=vecs, right=vecs,
                                  middle=torch.gather(lam, 1, idx))
        u, s, vh = torch.linalg.svd(m, full_matrices=False)
        r = min(self.r, s.shape[-1])
        return LowRankPayload(left=u[..., :r],
                              right=vh[:, :r, :].transpose(1, 2),
                              middle=s[:, :r])

    def decompress(self, payload: LowRankPayload, shape) -> torch.Tensor:
        return ((payload.left * payload.middle.unsqueeze(1))
                @ payload.right.transpose(1, 2))

    def aggregate(self, payloads: LowRankPayload, shape,
                  weights=None) -> torch.Tensor:
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return _lowrank_aggregate(payloads)

    def spec(self, shape) -> CompSpec:
        r = min(self.r, min(shape))
        return CompSpec(delta=r / min(shape), omega=None,
                        bits=r * FLOAT_BITS * (1 + shape[0] + shape[1]),
                        deterministic=True)


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """C = I (classical Newton's communication)."""

    def compress(self, m: torch.Tensor) -> DensePayload:
        return DensePayload(values=m, count=numel(m.shape[1:]))

    def decompress(self, payload: DensePayload, shape) -> torch.Tensor:
        return payload.values.reshape((-1, *shape))

    # aggregate: the base class's mean — the wire is the dense matrix

    def spec(self, shape) -> CompSpec:
        return CompSpec(delta=1.0, omega=None,
                        bits=numel(shape) * FLOAT_BITS, deterministic=True)


@dataclasses.dataclass(frozen=True)
class Zero(Compressor):
    """C = 0 (Newton-Zero / Newton-Star). The payload is empty."""

    def compress(self, m: torch.Tensor) -> SparsePayload:
        n = m.shape[0]
        return SparsePayload(values=m.reshape(n, -1)[:, :0],
                             indices=torch.zeros((n, 0), dtype=torch.int32,
                                                 device=m.device),
                             universe=numel(m.shape[1:]))

    def decompress(self, payload: SparsePayload, shape) -> torch.Tensor:
        n = payload.values.shape[0]
        return _scatter_flat(payload.values, payload.indices,
                             numel(shape)).reshape((n, *shape))

    def aggregate(self, payloads: SparsePayload, shape,
                  weights=None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=payloads.values.dtype,
                           device=payloads.values.device)

    def spec(self, shape) -> CompSpec:
        return CompSpec(delta=0.0, omega=None, bits=0, deterministic=True)


# ---------------------------------------------------------------------------
# Registry entries (string key -> factory(level))
# ---------------------------------------------------------------------------


@register_compressor("rankr", "rank")
def _make_rankr(level):
    return RankR(int(level))


@register_compressor("topk")
def _make_topk(level):
    return TopK(k=int(level))


@register_compressor("topk-sym")
def _make_topk_sym(level):
    return TopK(k=int(level), symmetric=True)


@register_compressor("blocktopk")
def _make_blocktopk(level):
    return BlockTopK(k_per_block=int(level))


@register_compressor("blocktopk-threshold")
def _make_blocktopk_threshold(level):
    return BlockTopKThreshold(k_per_block=int(level))


@register_compressor("identity", "none")
def _make_identity(level):
    return Identity()


@register_compressor("zero")
def _make_zero(level):
    return Zero()


# ---------------------------------------------------------------------------
# Stepsize rule (Assumptions 3.4 / 3.5)
# ---------------------------------------------------------------------------


def alpha_for(comp: Compressor, shape, rule: str = "auto") -> float:
    """Theoretical Hessian learning rate: 'one' -> 1 (3.4(ii)),
    'contract' -> 1 - sqrt(1 - delta) (3.4(i)), 'unbiased' ->
    1/(omega + 1) (3.5); 'auto' picks 'one' for contractive operators."""
    sp = comp.spec(shape)
    if rule == "auto":
        rule = "one" if sp.deterministic else "unbiased"
    if rule == "one":
        return 1.0
    if rule == "contract":
        if sp.delta is None:
            raise ValueError("rule 'contract' needs a contractive compressor")
        return 1.0 - (1.0 - sp.delta) ** 0.5
    if rule == "unbiased":
        if sp.omega is None:
            raise ValueError("rule 'unbiased' needs an unbiased compressor")
        return 1.0 / (sp.omega + 1.0)
    raise ValueError(rule)
