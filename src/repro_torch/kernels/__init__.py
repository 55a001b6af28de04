"""The port's kernels: one package per TPU kernel family, each with a
plain PyTorch version (``ref.py``) and the wrapper that launches its CUDA
kernel (``ops.py``). ``LAUNCHES`` counts each wrapper's launches, and
``ROUTES`` the launches per route of K8 and K9."""

from ._cuda import LAUNCHES, ROUTES, build_all, reset_launches
