"""f32 arithmetic that rounds the same on every device."""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import torch


@contextmanager
def full_f32():
    """Run the CUDA matrix products inside in full f32, whatever the
    caller's TF32 switch says (the JAX code asks for
    ``Precision.HIGHEST``), and restore the switch after. Also a
    decorator: ``@full_f32()``."""
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = was


@lru_cache(maxsize=None)
def _divisor(b: float, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """The 0-d divisor ``b`` on ``device``, made once: a fill on the
    device, not a copy from the host (which would wait for the stream).
    Never dropped: a captured CUDA graph reads it by address."""
    return torch.full((), b, dtype=dtype, device=device)


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as one correctly rounded f32 division.

    On CUDA, PyTorch computes ``tensor / python_scalar`` as
    ``tensor * (1 / scalar)``, which can differ from the division in the
    last bit; the JAX code (and the CUDA kernels) divide. A 0-d tensor on
    ``a``'s device as the divisor takes the elementwise division path."""
    return a / _divisor(float(b), a.dtype, a.device)
