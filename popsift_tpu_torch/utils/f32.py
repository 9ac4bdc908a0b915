"""f32 arithmetic that rounds the same on every device."""

from __future__ import annotations

import torch


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as one correctly rounded f32 division.

    On CUDA, PyTorch computes ``tensor / python_scalar`` as
    ``tensor * (1 / scalar)``, which can differ from the division in the
    last bit; the JAX code (and the CUDA kernels) divide. A 0-d tensor on
    ``a``'s device as the divisor takes the elementwise division path."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)
