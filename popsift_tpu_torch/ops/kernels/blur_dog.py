"""K5: fused separable Gaussian blur + DoG of one pyramid level
(csrc/blur_dog.cu).

Replaces popsift_tpu/ops/pallas/blur.py::blur_and_dog. Given blur level
l-1 of N planes, f32[N, H, W], and the level's full symmetric 1-D filter
(2S + 1 taps), returns (blur_l, dog_{l-1} = blur_l - blur_{l-1}), both
f32[N, H, W], with edge-replicated borders. One launch covers all N
planes: the frame-batched front runs it once per (octave, level).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

NAME = "blur_dog"
SOURCE = "popsift_tpu_torch/csrc/blur_dog.cu"
REPLACES = "popsift_tpu/ops/pallas/blur.py:126"
MAX_S = 24      # csrc/blur_dog.cu MAX_S
launches = 0


def _pad_edge(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Edge-replicate ``pad`` cells on both sides of ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(-pad, n + pad, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _conv1d_valid(x: torch.Tensor, kernel: np.ndarray, dim: int
                  ) -> torch.Tensor:
    """Valid-mode symmetric 1-D convolution along ``dim`` as the JAX
    shift-and-add: centre tap, then paired taps outward."""
    klen = kernel.shape[0]
    span = (klen + 1) // 2
    nout = x.shape[dim] - klen + 1
    center = span - 1
    out = x.narrow(dim, center, nout) * float(kernel[center])
    for off in range(1, span):
        out += ((x.narrow(dim, center - off, nout)
                 + x.narrow(dim, center + off, nout))
                * float(kernel[center + off]))
    return out


def _sep_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable blur of [..., H, W] with edge-replicated borders:
    horizontal pass, then vertical (popsift_tpu.ops.pyramid._sep_blur)."""
    pad = (kernel.shape[0] - 1) // 2
    x = _conv1d_valid(_pad_edge(img, pad, -1), kernel, -1)
    return _conv1d_valid(_pad_edge(x, pad, -2), kernel, -2)


def blur_dog_torch(src: torch.Tensor, kernel: np.ndarray, out=None):
    """Plain version: ``_sep_blur`` and the subtraction, in plain f32
    tensor ops. ``out`` = (blur, dog) tensors to write into."""
    blur = _sep_blur(src, kernel)
    dog = blur - src
    if out is None:
        return blur, dog
    out[0].copy_(blur)
    out[1].copy_(dog)
    return out


def _check_planes(name: str, t: torch.Tensor, shape) -> None:
    """[N, H, W] f32 with dense rows and planes (the plane stride is
    free, so a level of a [N, L, H, W] stack qualifies)."""
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected f32{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) != shape[2]:
        raise ValueError(f"{name}: each [H, W] plane must be contiguous")


def blur_dog(src: torch.Tensor, kernel: np.ndarray, out=None):
    """(blur_l, dog_{l-1}) of blur level l-1 ``src`` f32[N, H, W] under
    the full symmetric filter ``kernel``: plain version on the CPU,
    kernel K5 on a CUDA device. ``out`` = (blur, dog) f32[N, H, W]
    tensors to write into (planes may be strided); allocated if None."""
    global launches
    if src.dim() != 3:
        raise ValueError("blur_dog expects f32[N, H, W] planes")
    if src.device.type == "cpu":
        return blur_dog_torch(src, kernel, out)
    N, H, W = src.shape
    S = (kernel.shape[0] - 1) // 2
    if kernel.shape[0] != 2 * S + 1 or S > MAX_S:
        raise ValueError(f"blur_dog: filter of {kernel.shape[0]} taps "
                         f"(odd, at most {2 * MAX_S + 1})")
    if out is None:
        out = (torch.empty_like(src, memory_format=torch.contiguous_format),
               torch.empty_like(src, memory_format=torch.contiguous_format))
    blur, dog = out
    for nm, t in (("src", src), ("blur", blur), ("dog", dog)):
        _check_planes(f"blur_dog {nm}", t, (N, H, W))
        if t.device != src.device or t.device.type != "cuda":
            raise ValueError("blur_dog: every tensor must be on one CUDA "
                             f"device (got {t.device})")
    taps = np.ascontiguousarray(kernel[S:], dtype=np.float32)
    lib = build.load_library()
    rc = lib.ps_blur_dog(
        src.data_ptr(), src.stride(0), blur.data_ptr(), blur.stride(0),
        dog.data_ptr(), dog.stride(0), N, H, W,
        taps.ctypes.data_as(ctypes.c_void_p), S, build.stream_of(src))
    build.check(rc, NAME)
    launches += 1
    return blur, dog
