"""PyTorch/CUDA port of gaussian_transformer_tpu for NVIDIA Hopper (H100).

The JAX package ``gaussian_transformer_tpu`` stays the reference; this package
mirrors its module names so each counterpart is easy to find. It imports
``torch`` and never ``jax``, and nothing of the JAX package.

The Pallas kernels of the JAX package become CUDA C++ kernels written for
``sm_90a`` (sources in ``csrc/``), built with ``nvcc`` at first use and loaded
through ``ctypes`` (``kernels.py``). Every kernel has a plain PyTorch version
in the same module; wrappers take it only for CPU tensors.
"""

from gaussian_transformer_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
