"""numpy -> port converters: how the reference's data and state cross
over into the port (the parity tests hand the JAX package's arrays to
the port through these)."""

from __future__ import annotations

import numpy as np
import torch

from .core.extensions import FedNLPPBCState
from .core.fednl import FedNLState
from .core.fednl_bc import FedNLBCState
from .core.fednl_pp import FedNLPPState
from .core.objectives import LogRegData
from .device import resolve_device
from .engine.method import RoundDraws
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


def _state(cls, fields: dict, step, draws, device, dtype, **host):
    """``cls`` from the reference state's arrays (its key left behind)
    and its ``host`` values: ``draws`` is the round-draw source the
    state continues with, ``RoundDraws(0)`` if None."""
    dev = resolve_device(device)
    return cls(**{name: _tensor(val, dev, dtype)
                  for name, val in fields.items()}, **host,
               step=int(np.asarray(step)),
               draws=RoundDraws(0, dev) if draws is None else draws)


def fednl_state_from_numpy(x, h_local, h_global, step, device=None,
                           dtype: torch.dtype = torch.float64,
                           draws=None) -> FedNLState:
    """A reference ``FedNLState``'s arrays -> the port's ``FedNLState``."""
    return _state(FedNLState, dict(x=x, h_local=h_local, h_global=h_global),
                  step, draws, device, dtype)


def fednl_pp_state_from_numpy(w, h_local, l_local, g_local, h_global,
                              l_global, g_global, x, step, device=None,
                              dtype: torch.dtype = torch.float64,
                              draws=None) -> FedNLPPState:
    """A reference ``FedNLPPState``'s arrays -> the port's."""
    return _state(FedNLPPState, dict(
        w=w, h_local=h_local, l_local=l_local, g_local=g_local,
        h_global=h_global, l_global=l_global, g_global=g_global, x=x),
        step, draws, device, dtype)


def fednl_bc_state_from_numpy(z, w, grad_w, h_local, h_global, xi, x, step,
                              device=None, dtype: torch.dtype = torch.float64,
                              draws=None) -> FedNLBCState:
    """A reference ``FedNLBCState``'s arrays -> the port's (xi a host
    bool)."""
    return _state(FedNLBCState, dict(z=z, w=w, grad_w=grad_w,
                                     h_local=h_local, h_global=h_global,
                                     x=x),
                  step, draws, device, dtype, xi=bool(np.asarray(xi)))


def fednl_ppbc_state_from_numpy(z, w, h_local, l_local, g_local, h_global,
                                l_global, g_global, x, step, device=None,
                                dtype: torch.dtype = torch.float64,
                                draws=None) -> FedNLPPBCState:
    """A reference ``FedNLPPBCState``'s arrays -> the port's."""
    return _state(FedNLPPBCState, dict(
        z=z, w=w, h_local=h_local, l_local=l_local, g_local=g_local,
        h_global=h_global, l_global=l_global, g_global=g_global, x=x),
        step, draws, device, dtype)


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
