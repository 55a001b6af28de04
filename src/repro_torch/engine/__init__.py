"""The port's experiment engine: the ``Method`` round driver and the
string-keyed method registry."""

from ..core.compressors import available_compressors, make_compressor, scale_payload
from .method import (
    MethodBase,
    Oracles,
    RoundDraws,
    available_methods,
    make_method,
    register,
)
