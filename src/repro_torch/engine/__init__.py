"""The port's experiment engine (counterpart of ``repro.engine``): the
``Method`` round driver and registry, the tidy records and their wire
accounting, and the ``Sweep`` runner. ``method.py`` has the protocol,
``sweep.py`` the execution."""

from ..core.compressors import (
    available_compressors,
    make_compressor,
    payload_bits,
    register_compressor,
    scale_payload,
)
from ..wire.report import WireReport, wire_cost
from ..wire.traffic import LinkModel, link_model, round_seconds
from .method import (
    MethodBase,
    Oracles,
    RoundDraws,
    available_methods,
    make_method,
    register,
)
from .records import (
    bits_curve,
    bits_to_accuracy,
    entropy_bits_curve,
    init_bits,
    measured_bits_curve,
    measured_bits_per_round,
    rounds_to_accuracy,
    seconds_curve,
    seconds_per_round,
    summary_records,
    uplink_bits_per_round,
)
from .sweep import (
    CellResult,
    ExperimentSpec,
    Sweep,
    SweepResult,
    build_compressor,
    run_cell,
    run_sweep,
)

#: ``CohortSpec`` re-exported lazily: ``core.cohort`` imports this
#: package's ``method`` submodule (to register "fednl-cohort"), so the
#: import waits for the first access.


def __getattr__(name):
    if name == "CohortSpec":
        from ..core.cohort import CohortSpec

        return CohortSpec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
