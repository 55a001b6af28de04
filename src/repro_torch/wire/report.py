"""``WireReport`` — the one wire-cost surface, counterpart of
``repro.wire.report``.

    rep = wire_cost(comp, (d, d))
    rep.analytic_bits   # comp.spec(shape).bits — the paper's x-axis
    rep.raw_bits        # measured payload structure, raw 32-bit indices
    rep.entropy_bits    # same, index streams entropy-coded (estimate)
    rep.encoded_bytes   # len(codec.encode(payload)) on a sample input

The first three are shape-static (``comp.structure``: meta tensors, no
compute); the last is the codec run on a sample, because a real
encoder's output length is data-dependent. The reference draws its
default sample from ``PRNGKey(0)``, which torch cannot reproduce: the
port draws it from ``torch.Generator().manual_seed(0)``, so a default
``encoded_bytes`` can differ from the reference's; pass ``sample=`` to
encode the same matrix in both.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .traffic import LinkModel, round_seconds


@dataclasses.dataclass(frozen=True)
class WireReport:
    """Every wire-cost number for one (compressor, shape) pair.

    analytic_bits: the paper's analytic claim (``comp.spec(shape).bits``)
    raw_bits:      measured payload structure, raw 32-bit index streams
    entropy_bits:  measured payload structure, entropy-coded index
                   estimate (``<= raw_bits`` by construction)
    encoded_bytes: actual codec output length on the sample input
    value_format:  the codec value-stream format behind encoded_bytes
    """

    analytic_bits: int
    raw_bits: int
    entropy_bits: int
    encoded_bytes: int  # 0 when the report was built with encoded=False
    value_format: str = "raw"

    @property
    def encoded_bits(self) -> int:
        return 8 * self.encoded_bytes

    def seconds(self, link: Union[str, LinkModel], n: int = 1,
                seed: int = 0) -> float:
        """Simulated seconds to uplink the ENCODED buffer for one round
        of an n-silo cohort (``traffic.round_seconds``)."""
        return round_seconds(float(self.encoded_bits), link, n=n, seed=seed)


def analytic_bits(comp, shape):
    """One payload's analytic bits at ``shape`` (``comp.spec(shape).bits``,
    the paper's count): what ``wire_cost(...).analytic_bits`` reports, without
    measuring the payload's structure. Internal code asks here, not the
    deprecated accessor."""
    return comp.spec(shape).bits


def wire_cost(comp, shape, *, dtype: torch.dtype = torch.float64,
              value_format: str = "raw", sample=None, gen=None,
              encoded: bool = True) -> WireReport:
    """One ``WireReport`` per (compressor, shape).

    ``dtype`` is the payload's float (f64 by default, the paper's
    accounting). ``sample`` is the (shape) matrix the codec encodes (a
    tensor or array; default a standard normal from
    ``torch.Generator().manual_seed(0)``); ``gen`` the generator a
    randomized compressor draws from (default seeded 1, the reference's
    ``PRNGKey(1)`` in role). ``encoded=False`` skips compress and codec
    (``encoded_bytes`` is 0), which per-round accounting wants."""
    from ..core.compressors import payload_bits
    from .codec import encode_silos

    shape = tuple(int(s) for s in shape)
    if encoded:
        if sample is None:
            sample = torch.randn(shape, generator=torch.Generator()
                                 .manual_seed(0), dtype=dtype)
        m = torch.as_tensor(sample).to(dtype)
        if gen is None:
            gen = torch.Generator(device=m.device).manual_seed(1)
        # a stack of one silo, encoded as that silo
        nbytes = len(next(encode_silos(comp.compress(m[None], gen),
                                       value_format=value_format)))
    else:
        nbytes = 0
    return WireReport(
        analytic_bits=int(comp.spec(shape).bits),
        raw_bits=payload_bits(comp, shape, dtype=dtype),
        entropy_bits=payload_bits(comp, shape, dtype=dtype,
                                  index_coding="entropy"),
        encoded_bytes=nbytes,
        value_format=value_format,
    )


def silo_encoded_bytes(payloads, value_format: str = "raw") -> np.ndarray:
    """Per-silo encoded sizes (bytes) of a STACKED payload — the array
    the traffic model prices for a heterogeneous cohort."""
    from .codec import encode_silos

    return np.array([len(b) for b in
                     encode_silos(payloads, value_format=value_format)],
                    dtype=np.int64)
