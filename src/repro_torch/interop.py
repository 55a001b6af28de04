"""numpy -> port converters: how the reference's data and state cross
over into the port (the parity tests hand the JAX package's arrays to
the port through these)."""

from __future__ import annotations

import numpy as np
import torch

from .core.fednl import FedNLState
from .core.objectives import LogRegData
from .device import resolve_device
from .second_order.fednl_precond import FedNLPrecondState
from .tree import tree_map


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy array (bf16 ones included: numpy has no bf16 of its own,
    so they cross as f32, which holds every bf16 value) as a tensor."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype)


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


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """A nested dict/list of numpy arrays (a reference parameter tree)
    -> the same tree of tensors, in each array's own dtype unless
    ``dtype`` is given."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev, dtype), tree)


def precond_state_from_numpy(step, h, mu, l=None,
                             device=None) -> FedNLPrecondState:
    """A reference ``FedNLPrecondState``'s trees -> the port's; ``l``
    None (or the reference's empty tuple) means no ridge stored yet."""
    dev = resolve_device(device)
    f32 = torch.float32
    unset = l is None or (isinstance(l, tuple) and not l)
    ridge = None if unset else params_from_numpy(l, dev, f32)
    return FedNLPrecondState(step=int(np.asarray(step)),
                             h=params_from_numpy(h, dev, f32),
                             mu=params_from_numpy(mu, dev, f32), l=ridge)
