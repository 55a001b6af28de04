"""FedNL core in PyTorch: Algorithm 1 and its variants (PP, CR, LS, BC,
stochastic Hessians, PP-BC, the cross-device cohort), the Newton family,
the paper's baselines, the compressors, the eq. (10) oracles and the
Newton-step linear algebra."""

from .compressors import (
    BlockSparsePayload,
    BlockTopK,
    BlockTopKThreshold,
    Compressor,
    CompSpec,
    DensePayload,
    DitheredPayload,
    Identity,
    LowRankPayload,
    NaturalSparsification,
    Payload,
    PowerSGD,
    RandK,
    RandomDithering,
    RankR,
    SparsePayload,
    TopK,
    Zero,
    ab_constants,
    alpha_for,
    available_compressors,
    canonical_float_bits,
    make_compressor,
    payload_bits,
    register_compressor,
    scale_payload,
)
from .cohort import (
    CohortFedNLPP,
    CohortFedNLPPState,
    CohortSpec,
    arrival_times,
    on_time_mask,
    sample_cohort,
    staleness_weights,
)
from .extensions import (
    ExactHessian,
    FedNLPPBC,
    FedNLPPBCState,
    StochasticFedNL,
    SubsampledHessian,
)
from .fednl import FedNL, FedNLState
from .fednl_bc import FedNLBC, FedNLBCState
from .fednl_cr import FedNLCR
from .fednl_ls import FedNLLS
from .fednl_pp import FedNLPP, FedNLPPState
from .linalg import (
    frob_norm,
    project_psd,
    solve_cubic_subproblem,
    solve_newton_system,
    symmetrize,
)
from .newton import (
    FixedHessian,
    N0LS,
    Newton,
    backtracking,
    fixed_hessian_run,
    n0_ls_run,
    newton_run,
    newton_step,
)
from .objectives import (
    LogRegData,
    QuadData,
    batch_grad,
    batch_hess,
    batch_value,
    global_grad,
    global_hess,
    global_value,
    lipschitz_constants,
)
