"""FedNL core in PyTorch: Algorithm 1, its compressors, the eq. (10)
oracles and the Newton-step linear algebra."""

from .compressors import (
    BlockSparsePayload,
    BlockTopK,
    BlockTopKThreshold,
    Compressor,
    CompSpec,
    DensePayload,
    Identity,
    LowRankPayload,
    RankR,
    SparsePayload,
    TopK,
    Zero,
    alpha_for,
    available_compressors,
    make_compressor,
    scale_payload,
)
from .fednl import FedNL, FedNLState
from .linalg import frob_norm, project_psd, solve_newton_system, symmetrize
from .newton import newton_run, newton_step
from .objectives import (
    LogRegData,
    batch_grad,
    batch_hess,
    batch_value,
    global_grad,
    global_hess,
    global_value,
    lipschitz_constants,
)
