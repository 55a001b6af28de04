"""The port's kernels: one package per TPU kernel family, each with a
plain PyTorch version (``ref.py``) and the wrapper that launches its CUDA
kernel (``ops.py``). ``LAUNCHES`` counts each wrapper's launches, and
``ROUTES`` the launches per route of K8 and K9."""

# What one block may hold on sm_90: 227 KB of shared memory (static and
# dynamic together) and the SM's 65,536 registers. Every launch of the
# port's kernels fits both (``resources.launch_resources``); the tuner and
# the ``smem-budget`` analysis rule hold every config to them.
SMEM_BUDGET_BYTES = 232_448
REGISTERS_PER_BLOCK = 65_536

from ._cuda import LAUNCHES, ROUTES, build_all, reset_launches  # noqa: E402
