"""The bitstream codec: real bytes for every registered payload family,
counterpart of ``repro.wire.codec`` and byte for byte its wire format.

``encode_silos(payloads) -> buffers`` / ``decode(data) -> payload`` turn
the port's payloads (``repro_torch.core.compressors``: SparsePayload,
BlockSparsePayload, LowRankPayload, DensePayload, DitheredPayload) into
actual byte buffers — the thing ``payload.bits()`` only *estimates*. The
codec is host-side by design: it runs at the payload boundary, after the
device tensors are pulled to the host, so the encoded length may be
data-dependent.

The port's payloads are always stacked over silos (``(n, k)``,
``(n, tiles, k)``, ...), so ``encode_silos`` is the entry point: one
buffer per silo. ``encode`` takes ONE silo's payload, in the reference's
one-silo form: the same dataclass with the silo axis dropped
(``values`` of shape ``(k,)``, ``(tiles, k)``; ``left`` ``(d0, r)``;
``norm`` ``(1,)``; a dense ``values`` of the matrix's shape), holding
tensors or numpy arrays — what ``decode`` returns, so
``encode(decode(b)) == b``. ``decode_silos`` stacks decoded silos back
into tensors for ``Compressor.decompress``.

Wire format (all integers little-endian / LEB128 varints, bitstreams
MSB-first and byte-aligned per section):

* **Index streams** (Sparse / BlockSparse / indexed Dense) are
  delta-coded Golomb–Rice: indices are shifted by +1 (so the ``-1``
  padding slot becomes symbol 0 and survives the round trip), sorted
  ascending (per tile for BlockSparse — value/index *pairs* move
  together, so the decoded dense matrix is unchanged), first-differenced
  and Rice-coded with an exhaustively-chosen per-stream parameter. For a
  uniform k-subset of d^2 slots this approaches the
  ``ceil(log2 C(d^2, k))`` entropy estimate that ``bits("entropy")``
  quotes. ``sort_indices=False`` keeps the payload's original pair
  order (zigzag-coded signed deltas — bigger stream, bit-exact order).
* **Value streams** ship in one of three formats: ``"raw"`` (the native
  dtype's bytes — bit-exact round trip for fp64/fp32/fp16 payloads),
  ``"fp16"`` (a float16 cast: decoded values equal
  ``orig.astype(float16).astype(orig.dtype)`` exactly, i.e. relative
  error <= 2^-11 for values in float16's normal range), and ``"int8"``
  (symmetric linear quantization with one float32 scale per stream:
  absolute error <= max|v| / 250 per entry, including the scale's own
  float32 rounding).
* **Dithered payloads** are categorical, not float: each entry packs a
  fixed-width level in [0, s] plus a 1-bit sign (2 bits when the level
  is 0, where the sign can also be +-0.0), and only the single q-norm
  float ships as raw bytes — so the dithered round trip is bit-exact
  under *every* value format.
* **Indexed DensePayloads** (Bernoulli sparsification) are encoded as
  their bit-level-nonzero entries plus a delta-Rice index stream — the
  index stream the estimate always charged but the in-memory payload
  never carried.

Round-trip contract: ``decode(encode(p))`` equals ``canonical(p)``
(the index-sorted twin; ``canonical`` is the identity for families
without an index stream) array-for-array, bit-exactly under
``value_format="raw"``; ``decompress(decode(encode(p)))`` equals
``decompress(p)`` for any sort order. Decoded payloads carry host numpy
arrays. The Rice streams are a Python loop per symbol, as the
reference's: the sweep's records never encode (``wire_cost(...,
encoded=False)``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator

import numpy as np
import torch

from ..core.compressors import (
    BlockSparsePayload,
    DensePayload,
    DitheredPayload,
    LowRankPayload,
    SparsePayload,
)
from .bitio import (
    BitReader,
    BitWriter,
    best_rice_param,
    read_rice_stream,
    unzigzag,
    write_rice_stream,
    zigzag,
)

_MAGIC = 0xFE
_VERSION = 1

_FAM_SPARSE = 1
_FAM_BLOCKSPARSE = 2
_FAM_LOWRANK = 3
_FAM_DENSE = 4
_FAM_DITHERED = 5

#: value-stream formats: raw native bytes (bit-exact), float16 cast,
#: int8 symmetric linear quantization (one f32 scale per stream)
VALUE_FORMATS = ("raw", "fp16", "int8")
_FMT_CODE = {"raw": 0, "fp16": 1, "int8": 2}
_FMT_NAME = {v: k for k, v in _FMT_CODE.items()}

_DTYPE_CODE = {np.dtype(np.float64): 0, np.dtype(np.float32): 1,
               np.dtype(np.float16): 2}
_DTYPE_FROM_CODE = {v: k for k, v in _DTYPE_CODE.items()}


class WireFormatError(ValueError):
    """Malformed or unsupported wire buffer / payload."""


# ---------------------------------------------------------------------------
# varints + value streams
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        raise WireFormatError(f"varint must be non-negative, got {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _read_varint(data: bytes, off: int) -> tuple[int, int]:
    out, shift = 0, 0
    while True:
        if off >= len(data):
            raise WireFormatError("truncated varint")
        b = data[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, off
        shift += 7


def _np(arr) -> np.ndarray:
    """Pull a tensor (or array) to host; contiguity not required."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _arrays(payload) -> list:
    """The names of a payload's array fields, in declaration order."""
    return [f.name for f in dataclasses.fields(payload)
            if isinstance(getattr(payload, f.name), (torch.Tensor,
                                                     np.ndarray))]


def _map(fn, payload):
    """``payload`` with ``fn`` applied to each array field."""
    return dataclasses.replace(payload, **{
        name: fn(getattr(payload, name)) for name in _arrays(payload)})


def _dtype_code(arr: np.ndarray) -> int:
    dt = np.dtype(arr.dtype)
    if dt not in _DTYPE_CODE:
        raise WireFormatError(f"unsupported value dtype {dt}")
    return _DTYPE_CODE[dt]


def _write_values(out: bytearray, arr: np.ndarray, fmt: str) -> None:
    """One float value stream in the chosen format (count/dtype live in
    the family header, not here)."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    if fmt == "raw":
        out += flat.tobytes()
    elif fmt == "fp16":
        out += flat.astype(np.float16).tobytes()
    elif fmt == "int8":
        max_abs = float(np.max(np.abs(flat))) if flat.size else 0.0
        scale = np.float32(max_abs / 127.0)
        out += struct.pack("<f", float(scale))
        if float(scale) > 0.0:
            q = np.clip(np.rint(flat / np.float64(scale)), -127, 127)
        else:
            q = np.zeros(flat.shape)
        out += q.astype(np.int8).tobytes()
    else:
        raise WireFormatError(f"unknown value format {fmt!r}")


def _read_values(data: bytes, off: int, count: int, dtype: np.dtype,
                 fmt: str) -> tuple[np.ndarray, int]:
    if fmt == "raw":
        nb = count * dtype.itemsize
        arr = np.frombuffer(data, dtype, count, off).copy()
        return arr, off + nb
    if fmt == "fp16":
        arr = np.frombuffer(data, np.float16, count, off).astype(dtype)
        return arr, off + 2 * count
    if fmt == "int8":
        (scale,) = struct.unpack_from("<f", data, off)
        q = np.frombuffer(data, np.int8, count, off + 4)
        arr = (q.astype(np.float64) * np.float64(scale)).astype(dtype)
        return arr, off + 4 + count
    raise WireFormatError(f"unknown value format {fmt!r}")


# ---------------------------------------------------------------------------
# index streams (delta + Golomb-Rice)
# ---------------------------------------------------------------------------
#
# Indices arrive as int32 with -1 reserved for padding; shifting by +1
# makes every symbol non-negative (padding = 0). Sorted mode emits
# non-negative first differences; unsorted mode zigzags the signed
# deltas. The mode byte packs the sorted flag (bit 7) with the Rice
# parameter (bits 0..4).


def _encode_index_rows(out: bytearray, idx_rows: np.ndarray) -> None:
    """Rice-code each row's sorted, shifted indices with per-row delta
    reset (rows = tiles for BlockSparse, one row for Sparse)."""
    shifted = idx_rows.astype(np.int64) + 1
    deltas = np.diff(shifted, axis=-1, prepend=0)
    flat = deltas.reshape(-1)
    if np.any(flat < 0):
        raise WireFormatError("index stream not sorted; encode sorts first")
    r = best_rice_param(flat)
    out.append(0x80 | r)
    w = BitWriter()
    write_rice_stream(w, flat.astype(np.uint64), r)
    out += w.getvalue()


def _encode_index_rows_unsorted(out: bytearray, idx_rows: np.ndarray) -> None:
    shifted = idx_rows.astype(np.int64) + 1
    deltas = np.diff(shifted, axis=-1, prepend=0)
    sym = zigzag(deltas.reshape(-1))
    r = best_rice_param(sym)
    out.append(r)
    w = BitWriter()
    write_rice_stream(w, sym, r)
    out += w.getvalue()


def _decode_index_rows(data: bytes, off: int, rows: int,
                       k: int) -> tuple[np.ndarray, int]:
    if rows * k == 0:
        return np.zeros((rows, k), np.int32), off
    mode = data[off]
    off += 1
    is_sorted, r = bool(mode & 0x80), mode & 0x1F
    rd = BitReader(data, start_bit=8 * off)
    sym = read_rice_stream(rd, rows * k, r)
    deltas = (sym.astype(np.int64) if is_sorted
              else unzigzag(sym)).reshape(rows, k)
    shifted = np.cumsum(deltas, axis=-1)
    idx = (shifted - 1).astype(np.int32)
    return idx, (rd.bit_position + 7) // 8


def _sort_pairs(values: np.ndarray, indices: np.ndarray):
    """Stable per-row sort of (value, index) pairs by index — the
    canonicalization the sorted index stream implies."""
    order = np.argsort(indices, axis=-1, kind="stable")
    return (np.take_along_axis(values, order, axis=-1),
            np.take_along_axis(indices, order, axis=-1))


# ---------------------------------------------------------------------------
# canonical form
# ---------------------------------------------------------------------------


def canonical(payload):
    """The codec's canonical twin of ``payload``: sparse families get
    their (value, index) pairs stably sorted by index per row (the order
    the sorted wire stream decodes to — dense reconstruction unchanged);
    families without an index stream are returned as-is. Arrays come
    back as host numpy."""
    if isinstance(payload, SparsePayload):
        v, i = _sort_pairs(_np(payload.values), _np(payload.indices))
        return dataclasses.replace(payload, values=v, indices=i)
    if isinstance(payload, BlockSparsePayload):
        v, i = _sort_pairs(_np(payload.values), _np(payload.indices))
        return dataclasses.replace(payload, values=v, indices=i)
    return _map(_np, payload)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _header(fam: int, fmt: str) -> bytearray:
    return bytearray((_MAGIC, _VERSION, fam, _FMT_CODE[fmt]))


def _check_rank(arr: np.ndarray, rank: int, what: str) -> None:
    if arr.ndim != rank:
        raise WireFormatError(
            f"{what} has rank {arr.ndim}, expected {rank} — a stacked "
            f"(silo-axis) payload must go through encode_silos")


def _encode_sparse(p: SparsePayload, fmt: str, sort: bool) -> bytes:
    values, indices = _np(p.values), _np(p.indices)
    _check_rank(values, 1, "SparsePayload.values")
    out = _header(_FAM_SPARSE, fmt)
    out.append(_dtype_code(values))
    _write_varint(out, values.shape[0])
    _write_varint(out, int(p.universe))
    if values.shape[0]:
        if sort:
            values, indices = _sort_pairs(values, indices)
            _encode_index_rows(out, indices[None, :])
        else:
            _encode_index_rows_unsorted(out, indices[None, :])
    _write_values(out, values, fmt)
    return bytes(out)


def _decode_sparse(data: bytes, off: int, fmt: str) -> SparsePayload:
    dtype = _DTYPE_FROM_CODE[data[off]]
    off += 1
    k, off = _read_varint(data, off)
    universe, off = _read_varint(data, off)
    idx, off = _decode_index_rows(data, off, 1, k)
    values, off = _read_values(data, off, k, dtype, fmt)
    return SparsePayload(values=values, indices=idx.reshape(-1),
                         universe=universe)


def _encode_blocksparse(p: BlockSparsePayload, fmt: str, sort: bool) -> bytes:
    values, indices = _np(p.values), _np(p.indices)
    _check_rank(values, 2, "BlockSparsePayload.values")
    nblk, k = values.shape
    out = _header(_FAM_BLOCKSPARSE, fmt)
    out.append(_dtype_code(values))
    _write_varint(out, nblk)
    _write_varint(out, k)
    _write_varint(out, int(p.universe))
    if nblk * k:
        if sort:
            values, indices = _sort_pairs(values, indices)
            _encode_index_rows(out, indices)
        else:
            _encode_index_rows_unsorted(out, indices)
    _write_values(out, values, fmt)
    return bytes(out)


def _decode_blocksparse(data: bytes, off: int, fmt: str) -> BlockSparsePayload:
    dtype = _DTYPE_FROM_CODE[data[off]]
    off += 1
    nblk, off = _read_varint(data, off)
    k, off = _read_varint(data, off)
    universe, off = _read_varint(data, off)
    idx, off = _decode_index_rows(data, off, nblk, k)
    values, off = _read_values(data, off, nblk * k, dtype, fmt)
    return BlockSparsePayload(values=values.reshape(nblk, k), indices=idx,
                              universe=universe)


def _encode_lowrank(p: LowRankPayload, fmt: str) -> bytes:
    left, right, mid = _np(p.left), _np(p.right), _np(p.middle)
    _check_rank(left, 2, "LowRankPayload.left")
    _check_rank(mid, 1, "LowRankPayload.middle")
    out = _header(_FAM_LOWRANK, fmt)
    for arr in (left, right, mid):
        out.append(_dtype_code(arr))
    _write_varint(out, left.shape[0])
    _write_varint(out, right.shape[0])
    _write_varint(out, left.shape[1])
    _write_varint(out, mid.shape[0])
    for arr in (left, right, mid):
        _write_values(out, arr, fmt)
    return bytes(out)


def _decode_lowrank(data: bytes, off: int, fmt: str) -> LowRankPayload:
    dts = [_DTYPE_FROM_CODE[data[off + i]] for i in range(3)]
    off += 3
    d0, off = _read_varint(data, off)
    d1, off = _read_varint(data, off)
    r, off = _read_varint(data, off)
    mid, off = _read_varint(data, off)
    left, off = _read_values(data, off, d0 * r, dts[0], fmt)
    right, off = _read_values(data, off, d1 * r, dts[1], fmt)
    middle, off = _read_values(data, off, mid, dts[2], fmt)
    return LowRankPayload(left=left.reshape(d0, r),
                          right=right.reshape(d1, r), middle=middle)


def _bitwise_nonzero(flat: np.ndarray) -> np.ndarray:
    """Entries whose *bit pattern* is non-zero (keeps -0.0, which must
    round-trip for the indexed dense wire)."""
    width = {8: np.uint64, 4: np.uint32, 2: np.uint16}[flat.dtype.itemsize]
    return np.nonzero(flat.view(width) != 0)[0]


def _encode_dense(p: DensePayload, fmt: str) -> bytes:
    values = _np(p.values)
    out = _header(_FAM_DENSE, fmt)
    out.append(_dtype_code(values))
    out.append(1 if p.indexed else 0)
    _write_varint(out, values.ndim)
    for s in values.shape:
        _write_varint(out, int(s))
    _write_varint(out, int(p.count))
    _write_varint(out, int(p.universe))
    if p.indexed:
        # the estimate's index stream, made real: ship only the occupied
        # slots (bit-level non-zero, so -0.0 survives) + their indices
        flat = np.ascontiguousarray(values).reshape(-1)
        nz = _bitwise_nonzero(flat)
        _write_varint(out, nz.shape[0])
        if nz.shape[0]:
            _encode_index_rows(out, nz[None, :].astype(np.int64))
        _write_values(out, flat[nz], fmt)
    else:
        _write_values(out, values, fmt)
    return bytes(out)


def _decode_dense(data: bytes, off: int, fmt: str) -> DensePayload:
    dtype = _DTYPE_FROM_CODE[data[off]]
    indexed = bool(data[off + 1])
    off += 2
    ndim, off = _read_varint(data, off)
    shape = []
    for _ in range(ndim):
        s, off = _read_varint(data, off)
        shape.append(s)
    count, off = _read_varint(data, off)
    universe, off = _read_varint(data, off)
    numel = int(np.prod(shape)) if shape else 1
    if indexed:
        nnz, off = _read_varint(data, off)
        idx, off = _decode_index_rows(data, off, 1, nnz)
        vals, off = _read_values(data, off, nnz, dtype, fmt)
        flat = np.zeros(numel, dtype)
        flat[idx.reshape(-1)] = vals
        values = flat.reshape(shape)
    else:
        values, off = _read_values(data, off, numel, dtype, fmt)
        values = values.reshape(shape)
    return DensePayload(values=values, count=count, indexed=indexed,
                        universe=universe)


def _encode_dithered(p: DitheredPayload, fmt: str) -> bytes:
    norm, signs, levels = _np(p.norm), _np(p.signs), _np(p.levels)
    lev = np.ascontiguousarray(levels).reshape(-1)
    sgn = np.ascontiguousarray(signs).reshape(-1)
    lev_i = np.rint(lev).astype(np.int64)
    if np.any(lev_i != lev) or np.any(lev_i < 0) or np.any(lev_i > p.s):
        raise WireFormatError(
            f"dithered levels must be integer-valued in [0, {p.s}]")
    if np.any((lev_i > 0) & (sgn == 0)):
        raise WireFormatError("positive level with zero sign is unencodable")
    out = _header(_FAM_DITHERED, fmt)
    out.append(_dtype_code(signs))
    _write_varint(out, int(p.s))
    _write_varint(out, signs.ndim)
    for s in signs.shape:
        _write_varint(out, int(s))
    out += np.ascontiguousarray(norm).reshape(-1)[:1].tobytes()  # always raw
    lbits = max(1, int(p.s).bit_length())
    w = BitWriter()
    negbit = np.signbit(sgn)
    for i in range(lev_i.shape[0]):
        li = int(lev_i[i])
        w.write(li, lbits)
        if li > 0:
            w.write(1 if negbit[i] else 0, 1)
        else:
            # level 0: sign in {+0.0, +1, -1, -0.0} -> 2 bits
            si = sgn[i]
            if si == 0:
                w.write(3 if negbit[i] else 0, 2)
            else:
                w.write(2 if negbit[i] else 1, 2)
    out += w.getvalue()
    return bytes(out)


def _decode_dithered(data: bytes, off: int, fmt: str) -> DitheredPayload:
    dtype = _DTYPE_FROM_CODE[data[off]]
    off += 1
    s, off = _read_varint(data, off)
    ndim, off = _read_varint(data, off)
    shape = []
    for _ in range(ndim):
        dim, off = _read_varint(data, off)
        shape.append(dim)
    norm = np.frombuffer(data, dtype, 1, off).copy()
    off += dtype.itemsize
    numel = int(np.prod(shape)) if shape else 1
    lbits = max(1, int(s).bit_length())
    rd = BitReader(data, start_bit=8 * off)
    levels = np.empty(numel, np.int64)
    signs = np.empty(numel, np.float64)
    for i in range(numel):
        li = rd.read(lbits)
        levels[i] = li
        if li > 0:
            signs[i] = -1.0 if rd.read(1) else 1.0
        else:
            code = rd.read(2)
            signs[i] = (0.0, 1.0, -1.0, -0.0)[code]
    return DitheredPayload(norm=norm,
                           signs=signs.astype(dtype).reshape(shape),
                           levels=levels.astype(dtype).reshape(shape),
                           s=s, count=numel)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def encode(payload, value_format: str = "raw",
           sort_indices: bool = True) -> bytes:
    """Serialize ONE silo's payload (no leading silo axis: the one-silo
    form of the module docstring) to wire bytes.

    ``value_format`` selects the value-stream coding ("raw" is
    bit-exact; "fp16"/"int8" are quantized with the documented bounds —
    dithered payloads are categorical and bit-exact under every
    format). ``sort_indices=False`` preserves the payload's pair order
    at the cost of a larger (zigzag) index stream; the default sorts,
    so ``decode(encode(p)) == canonical(p)``."""
    if value_format not in VALUE_FORMATS:
        raise WireFormatError(
            f"value_format must be one of {VALUE_FORMATS}, "
            f"got {value_format!r}")
    if isinstance(payload, SparsePayload):
        return _encode_sparse(payload, value_format, sort_indices)
    if isinstance(payload, BlockSparsePayload):
        return _encode_blocksparse(payload, value_format, sort_indices)
    if isinstance(payload, LowRankPayload):
        return _encode_lowrank(payload, value_format)
    if isinstance(payload, DensePayload):
        return _encode_dense(payload, value_format)
    if isinstance(payload, DitheredPayload):
        return _encode_dithered(payload, value_format)
    raise WireFormatError(f"no codec for payload type {type(payload).__name__}")


def decode(data: bytes, shape=None):
    """Deserialize wire bytes back into a payload (host numpy arrays).

    All structure lives in the buffer's header; ``shape`` is accepted
    for API symmetry with ``Compressor.decompress(payload, shape)`` and
    is only validated (dense/dithered families), never required."""
    if len(data) < 4 or data[0] != _MAGIC:
        raise WireFormatError("not a wire buffer (bad magic)")
    if data[1] != _VERSION:
        raise WireFormatError(f"unsupported wire version {data[1]}")
    fam, fmt = data[2], _FMT_NAME.get(data[3])
    if fmt is None:
        raise WireFormatError(f"unknown value-format code {data[3]}")
    off = 4
    if fam == _FAM_SPARSE:
        payload = _decode_sparse(data, off, fmt)
    elif fam == _FAM_BLOCKSPARSE:
        payload = _decode_blocksparse(data, off, fmt)
    elif fam == _FAM_LOWRANK:
        payload = _decode_lowrank(data, off, fmt)
    elif fam == _FAM_DENSE:
        payload = _decode_dense(data, off, fmt)
    elif fam == _FAM_DITHERED:
        payload = _decode_dithered(data, off, fmt)
    else:
        raise WireFormatError(f"unknown payload family code {fam}")
    if shape is not None and isinstance(payload,
                                        (DensePayload, DitheredPayload)):
        got = (payload.values.shape if isinstance(payload, DensePayload)
               else payload.signs.shape)
        if tuple(int(s) for s in shape) != tuple(got):
            raise WireFormatError(f"shape mismatch: buffer carries {got}, "
                                  f"caller expected {tuple(shape)}")
    return payload


def encode_silos(payloads, value_format: str = "raw",
                 sort_indices: bool = True) -> Iterator[bytes]:
    """Encode a STACKED payload (leading silo axis, as every port
    compressor makes it) one silo at a time — one byte buffer per silo,
    the unit the traffic model prices.

    LAZY: yields each silo's buffer as it is encoded, so n buffers are
    never all held at once. The stacked arrays are pulled to the host
    once, up front (one copy of the wire-sized payload); only the per-
    silo buffers stream."""
    names = _arrays(payloads)
    if not names:
        return
    n = int(getattr(payloads, names[0]).shape[0])
    host = _map(_np, payloads)
    for i in range(n):
        yield encode(_map(lambda a: a[i], host), value_format=value_format,
                     sort_indices=sort_indices)


def decode_silos(buffers, device=None):
    """Decode one buffer per silo and stack the silos: the stacked payload
    of tensors (on ``device``, default the CPU) that ``decompress`` and
    ``aggregate`` take."""
    silos = [decode(b) for b in buffers]
    if not silos:
        raise WireFormatError("no silo buffers to decode")
    first = silos[0]
    return dataclasses.replace(first, **{
        name: torch.from_numpy(np.stack([getattr(p, name) for p in silos]))
        .to(device or "cpu") for name in _arrays(first)})


def encoded_bytes(payload, value_format: str = "raw") -> int:
    """Actual wire size in BYTES of one silo's payload:
    ``len(encode(...))``. The measured-by-codec fourth column next to the
    analytic / raw / entropy bit estimates (``wire.report.wire_cost``)."""
    return len(encode(payload, value_format=value_format))
