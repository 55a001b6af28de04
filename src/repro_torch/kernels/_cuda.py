"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repository root under a name
that carries a hash of its source, the shared headers and ``NVCC_FLAGS``,
so an edited source or a changed flag is rebuilt and an unchanged one is
built once.
``build_all`` starts one ``nvcc`` per source at the same time.

``LAUNCHES`` counts, per wrapper, the launches of its kernel, and
``ROUTES`` the launches of each route of a wrapper that has several. A
wrapper counts (``count``) only where it launches; the plain CPU path
counts nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("block_topk", "scatter_accum", "hess_update", "tiled_matmul",
           "flash_attention", "flash_attention_wgmma")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "--warn-on-spills")

LAUNCHES = {"diff_topk_payload": 0, "scatter_accumulate": 0,
            "block_scatter_accumulate": 0, "block_topk_payload": 0,
            "block_topk": 0, "hess_update": 0, "tiled_matmul": 0,
            "flash_attention": 0}
ROUTES = {"tiled_matmul": {"tiled": 0, "small_n": 0, "small_k": 0},
          "flash_attention": {"wgmma": 0, "ffma": 0}}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def count(name: str, route: str | None = None) -> None:
    """One launch of ``name``'s kernel, by ``route`` where it has several."""
    LAUNCHES[name] += 1
    if route is not None:
        ROUTES[name][route] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    tag = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; None if the library exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel; returns nvcc's output
    (registers, shared memory, spills) per source that was built."""
    jobs = {name: _start_build(name) for name in SOURCES}
    return {name: _finish_build(name, job) for name, job in jobs.items()}


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# q, k, v and out by their strides; B, T, H, KV, hd, bq, bk, the window
# (0: none) and the stream
_FLASH_ARGS = [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _I, _I, _I,
               _I, _I, _I, _I, _I, _P]
# every source's launch query (``resources.query``): the kernel's index,
# the launch arguments it prices, five results
_QUERY = [_I, _P, _P]
# the launch entry points of each source
_SIGNATURES = {
    "block_topk": {
        **{f"diff_topk_payload_{t}": [_P, _P, _L, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _P]
           for t in ("f32", "f64")},
        **{f"block_topk_payload_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
           for t in ("f32", "f64")},
        **{f"block_topk_{t}": [_P, _P, _I, _I, _I, _I, _I, _P]
           for t in ("f32", "f64")},
    },
    "scatter_accum": {
        **{f"scatter_accumulate_{t}": [_P] * 5 + [ctypes.c_size_t]
           + [_P] * 7 + [_I] * 12 + [_P]
           for t in ("f32", "f64")},
        **{f"block_scatter_accumulate_{t}": [_P, _P, _P, _I, _I, _I, _I,
                                             _I, _P]
           for t in ("f32", "f64")},
    },
    "hess_update": {
        f"hess_update_{t}": [_P, _P, _P, _D, _P, _P, _I, _I, _I, _I, _P]
        for t in ("f32", "f64")},
    "tiled_matmul": {
        "tiled_matmul_f32": [_P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _P],
        "tiled_matmul_small_n_f32": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I,
                                     _I, _I, _I, _P],
        "tiled_matmul_small_k_f32": [_P, _L, _L, _P, _L, _L, _P, _I, _I, _I,
                                     _P]},
    # f32 on the CUDA cores (FFMA); bf16 on the tensor cores (wgmma)
    "flash_attention": {"flash_attention_f32": _FLASH_ARGS},
    "flash_attention_wgmma": {"flash_attention_bf16": _FLASH_ARGS},
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        query = getattr(lib, f"{name}_launch_query")
        query.argtypes, query.restype = _QUERY, ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def on(device: torch.device):
    """A context in which ``device`` is the current CUDA device, for a
    launch: none is entered when it is current already (entering
    ``torch.cuda.device`` on every launch weighs on small kernels)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream() -> int:
    """The current device's current stream as a raw pointer (no Stream
    object is made: this runs once per launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
