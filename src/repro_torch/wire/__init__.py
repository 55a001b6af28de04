"""repro_torch.wire — bytes on a wire, and what they cost (counterpart
of ``repro.wire``).

The host-side bitstream codec for every payload family (``codec``:
Golomb–Rice delta-coded index streams, raw/fp16/int8 value streams,
bit-exact fp32/fp64 round trips; the reference's wire format byte for
byte), the traffic model that turns bits into simulated seconds per
round (``traffic``), and the ``WireReport`` cost surface
(``report.wire_cost``).

``traffic`` and ``report`` import before ``codec``: the codec reads the
compressors' payload classes, whose package imports the engine, which
imports this package's traffic model and report.
"""

from .bitio import BitReader, BitWriter, best_rice_param
from .traffic import (
    PRESETS,
    LinkModel,
    link_model,
    round_seconds,
    seconds_curve,
    transfer_seconds,
)
from .report import WireReport, silo_encoded_bytes, wire_cost
from .codec import (
    VALUE_FORMATS,
    WireFormatError,
    canonical,
    decode,
    decode_silos,
    encode,
    encode_silos,
    encoded_bytes,
)

__all__ = [
    "BitReader", "BitWriter", "best_rice_param",
    "VALUE_FORMATS", "WireFormatError", "canonical", "decode",
    "decode_silos", "encode", "encode_silos", "encoded_bytes",
    "WireReport", "silo_encoded_bytes", "wire_cost",
    "PRESETS", "LinkModel", "link_model", "round_seconds", "seconds_curve",
    "transfer_seconds",
]
