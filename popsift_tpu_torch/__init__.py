"""popsift_tpu_torch — SIFT extraction in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of :mod:`popsift_tpu` (JAX/XLA/Pallas), which stays the
reference. Module names follow the JAX package so each module's
counterpart is easy to find; every Pallas kernel on the main path has a
CUDA C++ counterpart in ``csrc/`` with its plain PyTorch version beside
the wrapper in ``ops/kernels/``. The package never imports jax: it
shares only the jax-free modules of the JAX package (configuration,
filter tables, image I/O, the native host runtime).
"""

from .config import SiftConfig

__version__ = "0.1.0"

__all__ = ["SiftConfig"]
