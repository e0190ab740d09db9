"""apex_tpu_torch: the PyTorch/CUDA port of ``apex_tpu``.

The JAX package ``apex_tpu`` is the reference; every module here sits at
the same relative path as its JAX counterpart. Kernels that the JAX
package writes in Pallas for the TPU are CUDA C++ kernels for Hopper
(``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use and bound
through ``ctypes`` (``utils/cuda_build.py``). Every kernel has a plain
PyTorch version in the same module: a wrapper takes it for a tensor on
the CPU, and launches the kernel (or raises) for a tensor on the card.

Entry points run on the card by default (``device=None`` means
``torch.device("cuda")``); pass ``device="cpu"`` to run the plain
versions on the host, as the tests do.

This package imports neither ``jax`` nor ``apex_tpu``.
"""

__version__ = "0.1.0"
