"""popsift_tpu_torch — SIFT extraction in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a), descriptor matching and two-view
geometry.

The port of :mod:`popsift_tpu` (JAX/XLA/Pallas), which stays the
reference. Module names follow the JAX package so each module's
counterpart is easy to find; every Pallas kernel has a CUDA C++
counterpart in ``csrc/`` with its plain PyTorch version beside the
wrapper in ``ops/kernels/``; what the JAX package computes in XLA
(matching, ``sfm/``) is plain torch. The package never imports jax nor
the JAX package: it keeps its own copies of the jax-free modules it
needs (configuration, filter tables, image I/O, the native host
runtime).
"""

from .config import SiftConfig

__version__ = "0.1.0"

__all__ = ["SiftConfig"]
