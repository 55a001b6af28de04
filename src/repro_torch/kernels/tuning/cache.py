"""Winner cache for the kernel autotuner, counterpart of
``src/repro/kernels/tuning/cache.py``.

A tuned config is keyed on ``(op, d-bucket, k, n, dtype, device kind)``:

  op           the wrapper: "scatter_accumulate" (K2/K3), "hess_update"
               (K7), "tiled_matmul" (K8), "flash_attention" (K9)
  d-bucket     the operand shape with every dim rounded up to the next
               power of two (min 8): scatter_accumulate's (d0, d1),
               hess_update's h shape, tiled_matmul's A (M, K),
               flash_attention's (T, head dim) — so a winner at head dim
               64 never applies at 128
  k            scatter_accumulate's pairs per silo; flash_attention's
               query heads per KV head (n_rep); None elsewhere
  n            scatter_accumulate's silo count; tiled_matmul's N;
               flash_attention's window (None when causal only)
  dtype        the operand's dtype name ("float32", "bfloat16", ...)
  device kind  ``torch.cuda.get_device_name`` of the OPERAND's device with
               spaces as "_", or "cpu" — a winner measured on one card
               never applies to another, and never to the CPU

The key string is the reference's format, field for field, so the two
give the same string on the same inputs. The persisted JSON is
``{"schema": 1, "configs": {key: config}}``; ``REPRO_TORCH_TUNING_CACHE``
names one to preload (the port's own variable: a pin written for the TPU
never loads here). The in-memory cache is process-global: the wrappers
consult it when the caller gives no config, ``record`` stores winners.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

import numpy as np
import torch

_SCHEMA = 1

# Env var naming a JSON cache to preload (the pinned cache of a run).
CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One tuned launch decision; a field an op does not tune stays None
    and the op's untuned default applies.

    log_r, digit_bits, seg  scatter_accumulate's plan: regions of 2^log_r
                            cells, sort digits of digit_bits, warp
                            segments of seg entries (``ops.make_plan``)
    block                   hess_update's square tile edge
    chunks                  tiled_matmul's K chunks on the small_n route
    bq, bk                  flash_attention's query and key tiles
    """

    log_r: Optional[int] = None
    digit_bits: Optional[int] = None
    seg: Optional[int] = None
    block: Optional[int] = None
    chunks: Optional[int] = None
    bq: Optional[int] = None
    bk: Optional[int] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"KernelConfig: unknown fields {sorted(unknown)}")
        return cls(**{k: int(v) for k, v in d.items() if v is not None})


def bucket(x: int) -> int:
    """Next power of two >= x (min 8): the d-bucket dimension."""
    x = max(int(x), 8)
    b = 8
    while b < x:
        b *= 2
    return b


_KINDS: dict = {}


def device_kind(device=None) -> str:
    """The device-kind field of a key for an operand on ``device``: the
    CUDA device's name with spaces as "_" (cached per device), or "cpu"."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return dev.type
    index = torch.cuda.current_device() if dev.index is None else dev.index
    kind = _KINDS.get(index)
    if kind is None:
        kind = _KINDS[index] = torch.cuda.get_device_name(index).replace(
            " ", "_")
    return kind


def dtype_name(dtype) -> str:
    """"float32", "bfloat16", ...: a torch dtype's name, or numpy's for
    anything numpy reads as a dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def cache_key(op: str, shape=None, k=None, n=None, dtype=None,
              device: Optional[str] = None) -> str:
    """Deterministic flat key string; see the module docstring. ``device``
    is a device kind string (``device_kind``); None means "cpu"."""
    d_part = "-" if shape is None else "x".join(str(bucket(s)) for s in shape)
    dt = "-" if dtype is None else dtype_name(dtype)
    dev = "cpu" if device is None else device
    return "|".join([op, f"d{d_part}",
                     f"k{'-' if k is None else int(k)}",
                     f"n{'-' if n is None else int(n)}", dt, dev])


def parse_key(key: str):
    """(op, dims, k, n, dtype, device) of a key string."""
    op, d_part, k_part, n_part, dtype, device = key.split("|")
    dims = None if d_part == "d-" else tuple(
        int(s) for s in d_part[1:].split("x"))
    k = None if k_part == "k-" else int(k_part[1:])
    n = None if n_part == "n-" else int(n_part[1:])
    return op, dims, k, n, dtype, device


class TuningCache:
    """Thread-safe key -> KernelConfig store with JSON persistence."""

    def __init__(self, entries: Optional[dict] = None):
        self._lock = threading.Lock()
        self._entries: dict = dict(entries or {})

    def get(self, key: str) -> Optional[KernelConfig]:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: str, cfg: KernelConfig) -> None:
        with self._lock:
            self._entries[key] = cfg

    def entries(self) -> dict:
        with self._lock:
            return dict(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def save(self, path: str) -> None:
        doc = {"schema": _SCHEMA,
               "configs": {k: v.to_dict() for k, v in self.entries().items()}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != _SCHEMA:
            raise ValueError(
                f"tuning cache {path!r}: schema {doc.get('schema')!r} != "
                f"{_SCHEMA} — regenerate with the current tuner")
        return cls({k: KernelConfig.from_dict(v)
                    for k, v in doc.get("configs", {}).items()})


_active: Optional[TuningCache] = None
_active_lock = threading.Lock()


def get_cache() -> TuningCache:
    """The process-global cache; first use loads ``$REPRO_TORCH_TUNING_CACHE``
    when set, else starts empty (the untuned defaults apply)."""
    global _active
    with _active_lock:
        if _active is None:
            path = os.environ.get(CACHE_ENV)
            _active = TuningCache.load(path) if path and os.path.exists(path) \
                else TuningCache()
        return _active


def set_cache(cache: Optional[TuningCache]) -> None:
    """Swap the process-global cache (None: load lazily from the env var
    again) — the test seam and the explicit pre-warm entry point."""
    global _active
    with _active_lock:
        _active = cache


def lookup(op: str, shape=None, k=None, n=None, dtype=None,
           device=None) -> Optional[KernelConfig]:
    """The tuned config for this op and problem on ``device`` (the
    operand's), or None: the untuned default applies. An empty cache
    answers before any key is built."""
    cache = get_cache()
    if len(cache) == 0:
        return None
    return cache.get(cache_key(op, shape=shape, k=k, n=n, dtype=dtype,
                               device=device_kind(device)))


def record(op: str, cfg: KernelConfig, shape=None, k=None, n=None,
           dtype=None, device=None) -> str:
    """Store a winner measured on ``device`` in the process-global cache;
    returns its key."""
    key = cache_key(op, shape=shape, k=k, n=n, dtype=dtype,
                    device=device_kind(device))
    get_cache().put(key, cfg)
    return key
