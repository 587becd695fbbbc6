"""LSHM on PyTorch and CUDA: a port of the ``lshm_tpu`` JAX package for NVIDIA Hopper.

The module layout mirrors ``lshm_tpu``.  The package imports torch and numpy, never JAX
or anything of ``lshm_tpu``.  Its hand-written CUDA kernels (``csrc/``) are built with
``nvcc`` at first use; on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead.
"""

from lshm_tpu_torch.config import Config, check_supported, preset

__all__ = ["Config", "check_supported", "preset"]
