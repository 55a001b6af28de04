"""numpy -> port converters: how the reference's data and state cross
over into the port (the parity tests hand the JAX package's arrays to
the port through these)."""

from __future__ import annotations

import numpy as np
import torch

from .core.fednl import FedNLState
from .core.objectives import LogRegData
from .device import resolve_device


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def logreg_from_numpy(a, b, lam: float, device=None,
                      dtype: torch.dtype = torch.float64) -> LogRegData:
    """(n, m, d) features, (n, m) labels -> ``LogRegData``."""
    dev = resolve_device(device)
    return LogRegData(a=_tensor(a, dev, dtype), b=_tensor(b, dev, dtype),
                      lam=float(lam))


def fednl_state_from_numpy(x, h_local, h_global, step, device=None,
                           dtype: torch.dtype = torch.float64) -> FedNLState:
    """A reference ``FedNLState``'s arrays -> the port's ``FedNLState``."""
    dev = resolve_device(device)
    return FedNLState(x=_tensor(x, dev, dtype),
                      h_local=_tensor(h_local, dev, dtype),
                      h_global=_tensor(h_global, dev, dtype),
                      step=int(np.asarray(step)))
