"""Model configurations the port runs, copied from the JAX package's
``configs`` (the port imports nothing of it), each with the exact
parameter tree its model's ``init_params`` builds.

``get_config(name)`` returns the published configuration;
``get_config(name, smoke=True)`` the reduced same-family variant of the
CPU tests. ``ARCHS`` lists the architectures ported so far.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import torch

from ..models.config import NOT_PORTED, ModelConfig

ARCHS = ("qwen2-0.5b",)
# the reference's other architectures (src/repro/configs/__init__.py)
_LATER = ("jamba-1.5-large-398b", "starcoder2-15b", "whisper-tiny",
          "minicpm3-4b", "starcoder2-3b", "granite-moe-1b-a400m",
          "grok-1-314b", "xlstm-350m", "llava-next-34b")


class ParamShape(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in _LATER:
        raise KeyError(f"arch {name!r} is {NOT_PORTED}; ported: {ARCHS}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG.reduced() if smoke else mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "ParamShape", "get_config"]
