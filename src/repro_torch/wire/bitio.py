"""Bit-granular I/O and Golomb–Rice coding — the primitives under the
wire codec (``repro_torch.wire.codec``), a copy of ``repro.wire.bitio``.

Everything here is host-side numpy/bytes: the codec runs at the payload
boundary, after device tensors have been pulled to the host.
``BitWriter``/``BitReader`` are MSB-first within each byte (the
conventional bitstream order), and
the Golomb–Rice coder is the classic unary-quotient + ``r``-bit
remainder code: a non-negative symbol ``v`` costs ``(v >> r) + 1 + r``
bits. ``best_rice_param`` picks ``r`` by exhaustive exact cost over a
small candidate range (vectorized — the cost of Rice coding is linear
in the symbols either way), so the index streams the codec emits are
within one header byte of the best this code family can do.

Signed symbols (unsorted index deltas) go through zigzag mapping
(0, -1, 1, -2, ... -> 0, 1, 2, 3, ...) so small magnitudes of either
sign stay cheap.
"""

from __future__ import annotations

import numpy as np

_MAX_RICE_PARAM = 30


class BitWriter:
    """Append-only MSB-first bit buffer backed by a Python int window."""

    def __init__(self):
        self._chunks = bytearray()
        self._acc = 0       # pending bits, MSB-first
        self._nbits = 0     # number of pending bits in _acc

    def write(self, value: int, nbits: int) -> None:
        """Append the low ``nbits`` bits of ``value`` (MSB first)."""
        if nbits == 0:
            return
        if value < 0 or (value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._chunks.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary(self, q: int) -> None:
        """``q`` one-bits then a terminating zero-bit."""
        while q >= 32:
            self.write(0xFFFFFFFF, 32)
            q -= 32
        self.write(((1 << q) - 1) << 1, q + 1)

    def write_rice(self, value: int, r: int) -> None:
        """Golomb–Rice: unary quotient ``value >> r``, then ``r``-bit
        remainder."""
        self.write_unary(int(value) >> r)
        if r:
            self.write(int(value) & ((1 << r) - 1), r)

    def getvalue(self) -> bytes:
        """Byte-align (zero padding) and return the buffer."""
        out = bytearray(self._chunks)
        if self._nbits:
            out.append((self._acc << (8 - self._nbits)) & 0xFF)
        return bytes(out)

    def __len__(self) -> int:  # bits written so far
        return 8 * len(self._chunks) + self._nbits


class BitReader:
    """MSB-first reader over a ``bytes`` buffer."""

    def __init__(self, data: bytes, start_bit: int = 0):
        self._data = data
        self._pos = start_bit

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        end = self._pos + nbits
        if end > 8 * len(self._data):
            raise ValueError("bitstream underrun")
        out = 0
        pos = self._pos
        while nbits > 0:
            byte = self._data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, nbits)
            shift = avail - take
            out = (out << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            nbits -= take
        self._pos = pos
        return out

    def read_unary(self) -> int:
        q = 0
        while self.read(1):
            q += 1
        return q

    def read_rice(self, r: int) -> int:
        q = self.read_unary()
        return (q << r) | (self.read(r) if r else 0)

    @property
    def bit_position(self) -> int:
        return self._pos


# ---------------------------------------------------------------------------
# Golomb–Rice streams over numpy symbol arrays
# ---------------------------------------------------------------------------


def zigzag(values: np.ndarray) -> np.ndarray:
    """Signed -> unsigned: 0,-1,1,-2,... -> 0,1,2,3,... (int64 safe)."""
    v = values.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def unzigzag(values: np.ndarray) -> np.ndarray:
    v = values.astype(np.uint64)
    return ((v >> np.uint64(1)).astype(np.int64)
            ^ -(v & np.uint64(1)).astype(np.int64))


def best_rice_param(symbols: np.ndarray) -> int:
    """Exact-cost argmin over r in [0, 30] for non-negative symbols."""
    if symbols.size == 0:
        return 0
    s = symbols.astype(np.uint64)
    best_r, best_cost = 0, None
    for r in range(_MAX_RICE_PARAM + 1):
        cost = int(np.sum(s >> np.uint64(r))) + s.size * (r + 1)
        if best_cost is None or cost < best_cost:
            best_r, best_cost = r, cost
    return best_r


def rice_stream_bits(symbols: np.ndarray, r: int) -> int:
    """Exact bit length of the Rice stream for ``symbols`` at param ``r``."""
    if symbols.size == 0:
        return 0
    s = symbols.astype(np.uint64)
    return int(np.sum(s >> np.uint64(r))) + s.size * (r + 1)


def write_rice_stream(w: BitWriter, symbols: np.ndarray, r: int) -> None:
    for v in symbols.astype(np.uint64).tolist():
        w.write_rice(int(v), r)


def read_rice_stream(rd: BitReader, count: int, r: int) -> np.ndarray:
    out = np.empty(count, np.uint64)
    for i in range(count):
        out[i] = rd.read_rice(r)
    return out
