"""Device meshes over ``torch.distributed``, counterpart of
``src/repro/launch/mesh.py``.

Kept as functions (never module-level constants), so importing this
module touches no device and starts no process group.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _ensure_group(dev: torch.device) -> None:
    """Join the default process group: the one already made, the one
    ``torchrun`` describes (``WORLD_SIZE`` in the environment), or else a
    one-rank group of this process alone."""
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(dev))
        return
    dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                            world_size=1)


@contextlib.contextmanager
def scoped_group():
    """A block whose default process group, if made inside it (by
    ``make_host_mesh``, say), is destroyed on leaving it; a group that
    was already there is left as it is."""
    made = not dist.is_initialized()
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _mesh(dev: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_group(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks per pod; ``multi_pod`` adds a leading 2-pod
    axis. The default group must hold that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(resolve_device(device), shape, names)


def make_host_mesh(data: int | None = None, model: int = 1, device=None):
    """A ``("data", "model")`` mesh over the ranks of the default process
    group (one rank when this process was started alone), on the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return _mesh(dev, (data, model), ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def extents(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh``: what the sharding rules
    (``launch/sharding.py``) read of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
