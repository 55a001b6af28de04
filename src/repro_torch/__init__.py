"""FedNL in PyTorch: the CUDA port of the ``repro`` JAX package.

The package mirrors ``repro``'s module names (``core/``, ``data/``,
``engine/``, ``wire/``, ``second_order/``, ``configs/``, ``launch/``,
``kernels/<name>/{ref,ops}.py``) so each module's counterpart is easy to
find. It imports ``torch`` and never ``jax``.

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
The kernels of FedNL Algorithm 1 and of the curvature-learning
optimizer are CUDA C++ sources in ``csrc/``, built with ``nvcc`` on
first use; on a CPU tensor every kernel wrapper runs its plain PyTorch
version instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
