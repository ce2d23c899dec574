"""PyTorch/CUDA port of ``vaura_tpu`` for NVIDIA Hopper (H100).

The JAX package ``vaura_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``models/``) so each module has a counterpart there. It
imports torch, numpy and the standard library only: never jax, flax or
``vaura_tpu``.

The TPU Pallas kernels of the generation path are replaced by hand-written
CUDA C++ kernels for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
(``kernels/build.py``). Every kernel wrapper keeps a plain PyTorch version of
the same function, taken only for tensors that lie on the CPU.
"""

from vaura_tpu_torch.utils import resolve_device

__all__ = ["resolve_device"]
