"""The port's kernels: one package per TPU kernel family, each with a
plain PyTorch version (``ref.py``) and the wrapper that launches its CUDA
kernel (``ops.py``). ``LAUNCHES`` counts each wrapper's launches."""

from ._cuda import LAUNCHES, build_all, reset_launches
