"""Second-order optimizers on parameter trees: FedNL curvature learning
(``fednl_precond``) beside the first-order substrate (``optim``)."""

from .fednl_precond import (
    FedNLPrecondOptimizer,
    FedNLPrecondState,
    fednl_precond,
)
from .optim import Optimizer, OptState, adamw, apply_updates, sgd
