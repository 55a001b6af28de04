from .ops import hess_update
from .ref import hess_update_ref
