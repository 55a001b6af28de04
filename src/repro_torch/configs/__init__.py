"""Model configurations the port runs at full width, copied from the JAX
package's ``configs`` (the port imports nothing of it), each with the
exact parameter tree its model's ``init_params`` builds."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of the reference's ``ModelConfig`` that fix the shapes
    of a dense decoder's parameter tree."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    source: str = ""

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads


class ParamShape(NamedTuple):
    shape: tuple
    dtype: torch.dtype

