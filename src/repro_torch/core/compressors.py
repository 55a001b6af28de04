"""Compression operators for FedNL (Definitions 3.2 and 3.3) as wire
codecs, counterpart of ``repro.core.compressors``.

Every compressor works on a STACK of silo matrices: the silo axis that
the reference vmaps over is the leading dimension here.

    payload = comp.compress(m, gen)           # m: (n, *shape)
    dense   = comp.decompress(payload, shape) # (n, *shape)
    mean    = comp.aggregate(payload, shape)  # (*shape) server mean

A randomized compressor (Def 3.2) splits ``compress`` into two steps:
``draw(n, shape, dtype, gen)``, the random variates from a
``torch.Generator`` (Rand-K's indices, dithering's uniforms, natural
sparsification's mask), and ``apply(m, draw)``, the deterministic rest.
``compress`` does both and raises without a generator, as the
reference asserts on its key; a caller that holds the draws (a method's
round-draw source, or a test replaying the reference's) calls ``apply``.
A deterministic compressor draws nothing: its ``apply`` is ``compress``.

The server never decompresses a silo: ``aggregate`` sums the stacked
payloads straight into one dense accumulator — the ``scatter_accum``
kernels for the sparse families, one factor contraction for Rank-R.
Top-K selection breaks ties toward the lower flat index, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` does
not promise that order).

A payload measures its own wire size: ``payload.bits(index_coding)``
reads only the trailing dims and dtypes of its arrays, so a stacked
payload reports bits per silo. ``comp.structure(shape, dtype)`` is one
silo's payload of ``meta`` tensors — its structure, built from the shape
alone, without computing or allocating anything at the tensor's size —
and ``payload_bits(comp, shape)`` asks it, as the reference asks
``jax.eval_shape``. The port has no ambient float: widths default to
f64, the paper's accounting, and take ``dtype=`` otherwise.
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
from .linalg import frob_norm

FLOAT_BITS = 64  # the paper counts double-precision floats
INDEX_BITS = 32


def numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _dtype_bits(x) -> int:
    """Wire width of one element of ``x`` (a tensor, meta included, or a
    numpy array)."""
    if isinstance(x, torch.Tensor):
        return 8 * x.element_size()
    return 8 * x.dtype.itemsize


def canonical_float_bits(dtype: torch.dtype = torch.float64) -> int:
    """Bits of the float every method ships uncompressed (gradients,
    l_i): 64 by default, the paper's accounting and the reference's under
    x64; the sweep passes its problem's dtype."""
    return 8 * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Payloads — the wire objects, stacked over silos
# ---------------------------------------------------------------------------


class Payload:
    """The wire-object surface every payload family shares.

    ``index_coding="raw"`` counts index streams at INDEX_BITS per entry;
    ``"entropy"`` swaps them for ceil(log2 C(universe, k)). Only the
    families that carry an index stream (Sparse, BlockSparse, indexed
    Dense) implement ``_entropy_bits``; for the others the argument is a
    no-op. ``repro_torch.wire.wire_cost`` returns every accounting at
    once."""

    def bits(self, index_coding: str = "raw") -> int:
        """Wire size in bits of ONE silo's payload (trailing dims)."""
        if index_coding not in ("raw", "entropy"):
            raise ValueError(f"index_coding must be 'raw' or 'entropy', "
                             f"got {index_coding!r}")
        if index_coding == "entropy":
            eb = self._entropy_bits()
            if eb is not None:
                return eb
        return self._raw_bits()

    def _raw_bits(self) -> int:
        raise NotImplementedError

    def _entropy_bits(self) -> Optional[int]:
        return None

    def encode(self, value_format: str = "raw") -> bytes:
        """This one-silo payload as wire bytes (``wire.codec.encode``)."""
        from ..wire.codec import encode

        return encode(self, value_format=value_format)


def _entropy_index_bits(k: int, universe: int) -> int:
    """ceil(log2 C(universe, k)), the information cost of a k-subset of
    ``universe`` slots, capped at the raw k * INDEX_BITS."""
    if k <= 0 or universe <= 0 or k >= universe:
        return 0
    ln2 = math.log(2.0)
    log2c = (math.lgamma(universe + 1) - math.lgamma(k + 1)
             - math.lgamma(universe - k + 1)) / ln2
    return min(k * INDEX_BITS, math.ceil(log2c))


@dataclasses.dataclass(frozen=True)
class SparsePayload(Payload):
    """k (value, flat-index) pairs per silo; -1 marks an empty slot.
    ``universe`` is the number of addressable slots."""

    values: torch.Tensor   # (n, k)
    indices: torch.Tensor  # (n, k) int32
    universe: int = 0

    def _raw_bits(self) -> int:
        k = int(self.values.shape[-1])
        return k * (_dtype_bits(self.values) + _dtype_bits(self.indices))

    def _entropy_bits(self) -> Optional[int]:
        if not self.universe:
            return None
        k = int(self.values.shape[-1])
        return (k * _dtype_bits(self.values)
                + _entropy_index_bits(k, self.universe))


@dataclasses.dataclass(frozen=True)
class BlockSparsePayload(Payload):
    """k (value, in-tile flat index) pairs per (block x block) tile,
    tiles in row-major grid order; ``universe`` is block^2."""

    values: torch.Tensor   # (n, tiles, k)
    indices: torch.Tensor  # (n, tiles, k) int32
    universe: int = 0

    def _raw_bits(self) -> int:
        nblk, k = (int(s) for s in self.values.shape[-2:])
        return nblk * k * (_dtype_bits(self.values)
                           + _dtype_bits(self.indices))

    def _entropy_bits(self) -> Optional[int]:
        if not self.universe:
            return None
        nblk, k = (int(s) for s in self.values.shape[-2:])
        return nblk * (k * _dtype_bits(self.values)
                       + _entropy_index_bits(k, self.universe))


@dataclasses.dataclass(frozen=True)
class LowRankPayload(Payload):
    """Rank-R factors: dense = (left * middle) @ right^T; PowerSGD's
    middle is its one rescale float."""

    left: torch.Tensor    # (n, d0, r)
    right: torch.Tensor   # (n, d1, r)
    middle: torch.Tensor  # (n, r), or PowerSGD's (n, 1)

    def _raw_bits(self) -> int:
        d0, r = (int(s) for s in self.left.shape[-2:])
        d1 = int(self.right.shape[-2])
        mid = int(self.middle.shape[-1])
        return (d0 * r + d1 * r + mid) * _dtype_bits(self.left)


@dataclasses.dataclass(frozen=True)
class DensePayload(Payload):
    """A dense array shipped as-is; ``count`` entries on the wire,
    ``indexed`` if each also ships an index (Bernoulli sparsification,
    charged its expected occupancy int(p * numel) of ``universe``)."""

    values: torch.Tensor
    count: int = 0
    indexed: bool = False
    universe: int = 0

    def _raw_bits(self) -> int:
        vbits = self.count * _dtype_bits(self.values)
        return vbits + self.count * INDEX_BITS if self.indexed else vbits

    def _entropy_bits(self) -> Optional[int]:
        if not (self.indexed and self.universe):
            return None
        return (self.count * _dtype_bits(self.values)
                + _entropy_index_bits(self.count, self.universe))


@dataclasses.dataclass(frozen=True)
class DitheredPayload(Payload):
    """Random dithering: one q-norm per silo, and per entry a sign and an
    integer-valued level in [0, s], stored as floats; charged 1 +
    ceil(log2(s + 1)) bits an entry."""

    norm: torch.Tensor    # (n, 1)
    signs: torch.Tensor   # (n, *shape)
    levels: torch.Tensor  # (n, *shape)
    s: int = 1
    count: int = 0

    def _raw_bits(self) -> int:
        level_bits = max(1, math.ceil(math.log2(self.s + 1)))
        return _dtype_bits(self.norm) + self.count * (1 + level_bits)


def _meta(*shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: shape and dtype, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


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
    the one leaf each format is linear in (values; low-rank middle;
    dithering's signs)."""
    if isinstance(payload, LowRankPayload):
        field = "middle"
    elif isinstance(payload, DitheredPayload):
        field = "signs"
    else:
        field = "values"
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
    (silo, rank); ``middle`` is (n, r) values or PowerSGD's (n, 1)
    rescale."""
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
    ``decompress(compress(m, gen))``. Deterministic compressors ignore
    ``gen``."""

    def compress(self, m: torch.Tensor, gen=None):
        raise NotImplementedError

    def draw(self, n: int, shape, dtype, gen) -> Optional[torch.Tensor]:
        """The random variates of n silos' compressions at ``shape``, on
        ``gen``'s device; None for a deterministic compressor."""
        return None

    def apply(self, m: torch.Tensor, draw=None):
        """``compress`` with its random variates given."""
        return self.compress(m)

    def decompress(self, payload, shape) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, m: torch.Tensor, gen=None) -> torch.Tensor:
        return self.decompress(self.compress(m, gen), m.shape[1:])

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

    def structure(self, shape, dtype=torch.float64) -> Payload:
        """One silo's payload at ``shape`` as ``meta`` tensors (a silo
        axis of 1): the structure ``compress`` would give, from the shape
        alone."""
        raise NotImplementedError

    def bits(self, shape) -> int:
        """Analytic wire bits of one application (= spec(shape).bits)."""
        return self.spec(shape).bits

    def encode(self, payload, value_format: str = "raw") -> bytes:
        """ONE silo's payload as wire bytes (``wire.codec.encode``)."""
        from ..wire.codec import encode

        return encode(payload, value_format=value_format)

    def decode(self, data: bytes, shape=None):
        """Wire bytes back into a one-silo payload of host numpy arrays
        (``wire.codec.decode``)."""
        from ..wire.codec import decode

        return decode(data, shape=shape)


def payload_bits(comp: Compressor, shape, dtype=torch.float64,
                 index_coding: str = "raw") -> int:
    """MEASURED wire bits of one payload at ``shape``, from its structure
    (``comp.structure``: meta tensors, no compute), as the reference's
    ``payload_bits`` reads ``jax.eval_shape``; ``wire_cost`` is the entry
    point that returns it beside the other accountings."""
    return int(comp.structure(tuple(int(s) for s in shape),
                              dtype).bits(index_coding=index_coding))


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

    def compress(self, m: torch.Tensor, gen=None) -> SparsePayload:
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

    def structure(self, shape, dtype=torch.float64) -> SparsePayload:
        slots = self._slots(tuple(shape))
        k = min(self.k, slots)
        return SparsePayload(values=_meta(1, k, dtype=dtype),
                             indices=_meta(1, k, dtype=torch.int32),
                             universe=slots)


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

    def structure(self, shape, dtype=torch.float64) -> BlockSparsePayload:
        b = self.block
        nblk = -(-int(shape[0]) // b) * -(-int(shape[1]) // b)
        return BlockSparsePayload(
            values=_meta(1, nblk, self._k(), dtype=dtype),
            indices=_meta(1, nblk, self._k(), dtype=torch.int32),
            universe=b * b)

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

    def compress(self, m: torch.Tensor, gen=None) -> BlockSparsePayload:
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

    def compress(self, m: torch.Tensor, gen=None) -> BlockSparsePayload:
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

    def compress(self, m: torch.Tensor, gen=None) -> LowRankPayload:
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

    def structure(self, shape, dtype=torch.float64) -> LowRankPayload:
        d0, d1 = (int(s) for s in shape)
        if self.symmetric:              # eigh of the (d0, d0) matrix
            d1 = d0
        r = min(self.r, d0 if self.symmetric else min(d0, d1))
        return LowRankPayload(left=_meta(1, d0, r, dtype=dtype),
                              right=_meta(1, d1, r, dtype=dtype),
                              middle=_meta(1, r, dtype=dtype))



def _orthonormalize(q: torch.Tensor) -> torch.Tensor:
    """Q of the reduced QR (Householder, as ``jnp.linalg.qr``)."""
    return torch.linalg.qr(q)[0]


@dataclasses.dataclass(frozen=True)
class PowerSGD(Compressor):
    """Rank-R approximation by ``iters`` rounds of subspace iteration
    (Vogels et al. 2019), scaled so ||C(M)||_F <= ||M||_F. Deterministic:
    the start subspace is a normal draw from ``seed`` in m's dtype, the
    same for every silo. Products are plain ``@`` in m's dtype, as the
    reference computes them. The payload is the two factors and the
    rescale float."""

    r: int
    iters: int = 2
    seed: int = 0

    def start(self, d1: int, dtype, device) -> torch.Tensor:
        """The (d1, r) start subspace drawn from ``seed``."""
        gen = torch.Generator().manual_seed(self.seed)
        return torch.randn((d1, self.r), generator=gen,
                           dtype=dtype).to(device)

    def compress(self, m: torch.Tensor, gen=None) -> LowRankPayload:
        return self.apply(m)

    def apply(self, m: torch.Tensor, draw=None) -> LowRankPayload:
        """``draw``: the (d1, r) start subspace; None draws it from
        ``seed``."""
        q = self.start(m.shape[2], m.dtype, m.device) if draw is None else draw
        q = _orthonormalize(q)
        mt = m.transpose(1, 2)
        for _ in range(self.iters):
            p = _orthonormalize(m @ q)          # (n, d0, r)
            q = _orthonormalize(mt @ p)         # (n, d1, r)
        p = m @ q                               # un-normalized left factor
        num = frob_norm(m)
        den = frob_norm(p @ q.transpose(1, 2))
        scale = torch.clamp(num / torch.clamp(den, min=1e-30), max=1.0)
        return LowRankPayload(left=p, right=q, middle=scale[:, None])

    def decompress(self, payload: LowRankPayload, shape) -> torch.Tensor:
        return ((payload.left @ payload.right.transpose(1, 2))
                * payload.middle[:, :, None])

    def aggregate(self, payloads: LowRankPayload, shape,
                  weights=None) -> torch.Tensor:
        # (L_i @ R_i^T) * mid_i == (L_i * mid_i) @ R_i^T: Rank-R's sum
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return _lowrank_aggregate(payloads)

    def spec(self, shape) -> CompSpec:
        r = min(self.r, min(shape))
        return CompSpec(delta=r / min(shape), omega=None,
                        bits=self.r * FLOAT_BITS * (shape[0] + shape[1])
                        + FLOAT_BITS,  # + the rescale float
                        deterministic=True)

    def structure(self, shape, dtype=torch.float64) -> LowRankPayload:
        d0, d1 = (int(s) for s in shape)
        # each reduced QR keeps min(rows, cols) columns
        r = min(self.r, d1) if self.iters == 0 else min(self.r, d0, d1)
        return LowRankPayload(left=_meta(1, d0, r, dtype=dtype),
                              right=_meta(1, d1, r, dtype=dtype),
                              middle=_meta(1, 1, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """C = I (classical Newton's communication)."""

    def compress(self, m: torch.Tensor, gen=None) -> DensePayload:
        return DensePayload(values=m, count=numel(m.shape[1:]), indexed=False)

    def decompress(self, payload: DensePayload, shape) -> torch.Tensor:
        return payload.values.reshape((-1, *shape))

    # aggregate: the base class's mean — the wire is the dense matrix

    def spec(self, shape) -> CompSpec:
        return CompSpec(delta=1.0, omega=None,
                        bits=numel(shape) * FLOAT_BITS, deterministic=True)

    def structure(self, shape, dtype=torch.float64) -> DensePayload:
        return DensePayload(values=_meta(1, *shape, dtype=dtype),
                            count=numel(shape), indexed=False)


@dataclasses.dataclass(frozen=True)
class Zero(Compressor):
    """C = 0 (Newton-Zero / Newton-Star). The payload is empty."""

    def compress(self, m: torch.Tensor, gen=None) -> SparsePayload:
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

    def structure(self, shape, dtype=torch.float64) -> SparsePayload:
        return SparsePayload(values=_meta(1, 0, dtype=dtype),
                             indices=_meta(1, 0, dtype=torch.int32),
                             universe=numel(shape))


# ---------------------------------------------------------------------------
# Unbiased compressors  B(omega)  — Def 3.2
# ---------------------------------------------------------------------------


def _need_gen(comp, gen) -> None:
    if gen is None:
        raise ValueError(f"{type(comp).__name__} is randomized; pass a "
                         "torch.Generator (or its draws to apply)")


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Rand-K with the numel/K rescale folded into the values (paper
    A.3.4), omega = numel/K - 1. The draw is each silo's K indices, the
    prefix of a uniform permutation."""

    k: int

    def draw(self, n: int, shape, dtype, gen) -> torch.Tensor:
        size = numel(shape)
        k = min(self.k, size)
        if k * k > size:   # a repeat is likely: the k least of size keys
            keys = torch.rand(n, size, generator=gen, dtype=torch.float64,
                              device=gen.device)
            return torch.topk(keys, k, dim=1, largest=False).indices
        # k uniform indices a row, the rows that repeat one drawn again: a
        # row without a repeat is a uniform ordered k-subset, and one is
        # so with probability about exp(-k^2 / 2 size) >= exp(-1/2)
        idx = torch.empty(n, k, dtype=torch.int64, device=gen.device)
        todo = torch.arange(n, device=gen.device)
        while todo.numel():
            cand = torch.randint(size, (todo.numel(), k), generator=gen,
                                 device=gen.device)
            s = torch.sort(cand, dim=1).values
            ok = torch.all(s[:, 1:] != s[:, :-1], dim=1)
            idx[todo[ok]] = cand[ok]
            todo = todo[~ok]
        return idx

    def compress(self, m: torch.Tensor, gen=None) -> SparsePayload:
        _need_gen(self, gen)
        return self.apply(m, self.draw(m.shape[0], m.shape[1:], m.dtype, gen))

    def apply(self, m: torch.Tensor, draw=None) -> SparsePayload:
        """``draw``: (n, K) flat indices."""
        flat = m.reshape(m.shape[0], -1)
        size = flat.shape[1]
        idx = draw.to(device=m.device, dtype=torch.int64)
        return SparsePayload(values=torch.gather(flat, 1, idx)
                             * (size / idx.shape[1]),
                             indices=idx.to(torch.int32), universe=size)

    def decompress(self, payload: SparsePayload, shape) -> torch.Tensor:
        n = payload.values.shape[0]
        return _scatter_flat(payload.values, payload.indices,
                             numel(shape)).reshape((n, *shape))

    def aggregate(self, payloads: SparsePayload, shape,
                  weights=None) -> torch.Tensor:
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return _sparse_aggregate(payloads, shape)

    def spec(self, shape) -> CompSpec:
        size = numel(shape)
        k = min(self.k, size)
        return CompSpec(delta=None, omega=size / k - 1.0,
                        bits=k * (FLOAT_BITS + INDEX_BITS),
                        deterministic=False)

    def structure(self, shape, dtype=torch.float64) -> SparsePayload:
        size = numel(shape)
        k = min(self.k, size)
        return SparsePayload(values=_meta(1, k, dtype=dtype),
                             indices=_meta(1, k, dtype=torch.int32),
                             universe=size)


def _qnorm(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row q-norm of (n, numel), as ``jnp.linalg.norm`` writes it."""
    if q == 2:
        return torch.sqrt(torch.sum(flat * flat, dim=1))
    if q == math.inf:
        return torch.amax(torch.abs(flat), dim=1)
    return torch.sum(torch.abs(flat) ** q, dim=1) ** (1.0 / q)


@dataclasses.dataclass(frozen=True)
class RandomDithering(Compressor):
    """Random dithering with s levels in the q-norm (paper A.3.1), omega
    <= min(d/s^2, sqrt(d)/s) for q = 2. The draw is one uniform per entry;
    an entry's level is bumped where its uniform falls below the
    fractional part of |x|/||x|| s, as ``jax.random.bernoulli`` compares
    its own uniform with p."""

    s: int
    q: float = 2.0

    def draw(self, n: int, shape, dtype, gen) -> torch.Tensor:
        return torch.rand((n, *shape), generator=gen, dtype=dtype,
                          device=gen.device)

    def compress(self, m: torch.Tensor, gen=None) -> DitheredPayload:
        _need_gen(self, gen)
        return self.apply(m, self.draw(m.shape[0], m.shape[1:], m.dtype, gen))

    def apply(self, m: torch.Tensor, draw=None) -> DitheredPayload:
        """``draw``: (n, *shape) uniforms in [0, 1)."""
        n = m.shape[0]
        norm = torch.clamp(_qnorm(m.reshape(n, -1), self.q), min=1e-30)
        nb = norm.reshape((n,) + (1,) * (m.dim() - 1))
        y = torch.abs(m) / nb * self.s          # in [0, s]
        low = torch.floor(y)
        bump = (draw.to(m.device) < y - low).to(m.dtype)
        return DitheredPayload(norm=norm[:, None], signs=torch.sign(m),
                               levels=low + bump, s=self.s,
                               count=numel(m.shape[1:]))

    def decompress(self, payload: DitheredPayload, shape) -> torch.Tensor:
        n = payload.signs.shape[0]
        norm = payload.norm.reshape((n,) + (1,) * (payload.signs.dim() - 1))
        out = payload.signs * norm * (payload.levels / self.s)
        return torch.where(norm > 1e-29, out, 0.0).reshape((n, *shape))

    def aggregate(self, payloads: DitheredPayload, shape,
                  weights=None) -> torch.Tensor:
        # the wire holds a level per entry: the mean of the decode is the
        # payload-space sum
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return torch.mean(self.decompress(payloads, shape), dim=0)

    def spec(self, shape) -> CompSpec:
        size = numel(shape)
        level_bits = max(1, math.ceil(math.log2(self.s + 1)))
        return CompSpec(
            delta=None,
            omega=min(size / self.s**2, math.sqrt(size) / self.s),
            bits=FLOAT_BITS + size * (1 + level_bits),
            deterministic=False)

    def structure(self, shape, dtype=torch.float64) -> DitheredPayload:
        return DitheredPayload(norm=_meta(1, 1, dtype=dtype),
                               signs=_meta(1, *shape, dtype=dtype),
                               levels=_meta(1, *shape, dtype=dtype),
                               s=self.s, count=numel(shape))


@dataclasses.dataclass(frozen=True)
class NaturalSparsification(Compressor):
    """Bernoulli(p) sparsification with the 1/p rescale, omega = 1/p - 1.
    The draw is each entry's Bernoulli(p) mask (an f64 uniform below p);
    the payload charges the expected occupancy int(p * numel)."""

    p: float

    def draw(self, n: int, shape, dtype, gen) -> torch.Tensor:
        return torch.rand((n, *shape), generator=gen, dtype=torch.float64,
                          device=gen.device) < self.p

    def compress(self, m: torch.Tensor, gen=None) -> DensePayload:
        _need_gen(self, gen)
        return self.apply(m, self.draw(m.shape[0], m.shape[1:], m.dtype, gen))

    def apply(self, m: torch.Tensor, draw=None) -> DensePayload:
        """``draw``: (n, *shape) bool mask."""
        size = numel(m.shape[1:])
        # where(), not m * mask / p: a dropped negative entry must be a
        # clean +0.0, not -0.0
        return DensePayload(values=torch.where(draw.to(m.device), m / self.p,
                                               0.0),
                            count=int(self.p * size), indexed=True,
                            universe=size)

    def decompress(self, payload: DensePayload, shape) -> torch.Tensor:
        return payload.values.reshape((-1, *shape))

    def aggregate(self, payloads: DensePayload, shape,
                  weights=None) -> torch.Tensor:
        if weights is not None:
            payloads = scale_payload(payloads, weights)
        return torch.mean(self.decompress(payloads, shape), dim=0)

    def spec(self, shape) -> CompSpec:
        return CompSpec(
            delta=None, omega=1.0 / self.p - 1.0,
            bits=int(self.p * numel(shape)) * (FLOAT_BITS + INDEX_BITS),
            deterministic=False)

    def structure(self, shape, dtype=torch.float64) -> DensePayload:
        size = numel(shape)
        return DensePayload(values=_meta(1, *shape, dtype=dtype),
                            count=int(self.p * size), indexed=True,
                            universe=size)


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


@register_compressor("powersgd")
def _make_powersgd(level):
    return PowerSGD(r=int(level), iters=2)


@register_compressor("randk")
def _make_randk(level):
    return RandK(k=int(level))


@register_compressor("dithering", "random-dithering")
def _make_dithering(level):
    return RandomDithering(s=int(level))


@register_compressor("natural")
def _make_natural(level):
    return NaturalSparsification(p=float(level))


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


def ab_constants(comp: Compressor, shape, alpha: float) -> tuple[float, float]:
    """(A, B) of eq. (5), selecting the assumption matching (comp, alpha)."""
    sp = comp.spec(shape)
    if sp.deterministic:
        if alpha == 1.0:
            return sp.delta / 4.0, 6.0 / sp.delta - 3.5
        return alpha**2, alpha
    return alpha, alpha
