"""K5: fused separable Gaussian blur + DoG of one pyramid level
(csrc/blur_dog.cu).

Replaces popsift_tpu/ops/pallas/blur.py::blur_and_dog. Given blur level
l-1 of N planes, f32[N, H, W], and the level's full symmetric 1-D filter
(2S + 1 taps), returns (blur_l, dog_{l-1} = blur_l - blur_{l-1}), both
f32[N, H, W], with edge-replicated borders. One launch covers all N
planes: the frame-batched front runs it once per (octave, level). The
same launch can write every second pixel of blur_l into a third tensor
(``pick``), the next octave's level 0.

The octaves whose plane is small enough for one block to beat their
level launches (:func:`thin_fits`) take ONE launch for all their levels and the picks
between them, one block a frame (:func:`blur_dog_thin`): their cost is
launch latency, not pixels.

The kernel marches 128-column strips down the plane: the horizontal
pass runs once per input row into a ring of rows in shared memory, and
both passes produce four outputs a thread from a register window, with
the plain version's terms in the plain version's order (csrc/blur_dog.cu
has the design note).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

NAME = "blur_dog"
SOURCE = "popsift_tpu_torch/csrc/blur_dog.cu"
REPLACES = "popsift_tpu/ops/pallas/blur.py:126"
NAME_THIN = "blur_dog_thin"
REPLACES_THIN = REPLACES    # the same TPU kernel, once per level there
MAX_S = 24      # csrc/blur_dog.cu MAX_S
# A plane of at most this many pixels goes through the one-launch thin entry.
# One block a frame needs about 9 ns a pixel for five levels (101.7 us for
# the 10,845 pixels of a 1080p frame's octaves 5-8), a level launch at least
# 2.6-3.9 us (NVIDIA H100 80GB HBM3, 700.00 W): the block wins below about
# 4,000 pixels, far below what its shared memory would hold (19,370).
THIN_PIXELS = 4096
THIN_MAX_OCTAVES = 8           # csrc/blur_dog.cu THIN_MAX_OCT
THIN_MAX_LEVELS = 12           # csrc/blur_dog.cu THIN_MAX_LEVELS
launches = 0
launches_thin = 0


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


def pick_every_second(blur: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """The [..., oh, ow] view of every second pixel of ``blur``
    (get_by_2_pick_every_second): the next octave's level 0."""
    return blur[..., 0::2, 0::2][..., :oh, :ow]


def blur_dog_torch(src: torch.Tensor, kernel: np.ndarray, out=None,
                   pick=None):
    """Plain version: ``_sep_blur`` and the subtraction, in plain f32
    tensor ops. ``out`` = (blur, dog) tensors to write into; ``pick``
    f32[N, oh, ow] takes every second pixel of the blur."""
    blur = _sep_blur(src, kernel)
    dog = blur - src
    if pick is not None:
        pick.copy_(pick_every_second(blur, *pick.shape[-2:]))
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


def blur_dog(src: torch.Tensor, kernel: np.ndarray, out=None, pick=None):
    """(blur_l, dog_{l-1}) of blur level l-1 ``src`` f32[N, H, W] under
    the full symmetric filter ``kernel``: plain version on the CPU,
    kernel K5 on a CUDA device. ``out`` = (blur, dog) f32[N, H, W]
    tensors to write into (planes may be strided); allocated if None.
    ``pick`` f32[N, oh, ow] (oh <= ceil(H/2), ow <= ceil(W/2), planes may
    be strided) takes ``blur[:, 2y, 2x]`` from the same launch."""
    global launches
    if src.dim() != 3:
        raise ValueError("blur_dog expects f32[N, H, W] planes")
    if src.device.type == "cpu":
        return blur_dog_torch(src, kernel, out, pick)
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
    oh = ow = 0
    if pick is not None:
        oh, ow = pick.shape[-2:]
        if pick.dim() != 3 or oh > (H + 1) // 2 or ow > (W + 1) // 2:
            raise ValueError(f"blur_dog pick: {list(pick.shape)} does not "
                             f"fit every second pixel of {[N, H, W]}")
        _check_planes("blur_dog pick", pick, (N, oh, ow))
        if pick.device != src.device:
            raise ValueError("blur_dog: every tensor must be on one CUDA "
                             f"device (got {pick.device})")
    taps = np.ascontiguousarray(kernel[S:], dtype=np.float32)
    lib = build.load_library()
    build.launch(
        NAME, src, lib.ps_blur_dog,
        src.data_ptr(), src.stride(0), blur.data_ptr(), blur.stride(0),
        dog.data_ptr(), dog.stride(0),
        None if pick is None else pick.data_ptr(),
        0 if pick is None else pick.stride(0), oh, ow, N, H, W,
        taps.ctypes.data_as(ctypes.c_void_p), S)
    launches += 1
    return blur, dog


def thin_fits(height: int, width: int, kernels) -> bool:
    """Whether an octave of this size, blurred with the level filters
    ``kernels``, can go through :func:`blur_dog_thin`."""
    return (height * width <= THIN_PIXELS
            and 1 <= len(kernels) <= THIN_MAX_LEVELS
            and all(k.shape[0] <= 2 * MAX_S + 1 for k in kernels))


def blur_dog_thin_torch(blurs, dogs, kernels, pick_level: int) -> None:
    """Plain version of :func:`blur_dog_thin`: the plain level blur, level
    by level and octave by octave, with the pick into the next octave."""
    for o, (levels, dog) in enumerate(zip(blurs, dogs)):
        nxt = blurs[o + 1][:, 0] if o + 1 < len(blurs) else None
        for lvl, kernel in enumerate(kernels, start=1):
            blur_dog_torch(levels[:, lvl - 1], kernel,
                           out=(levels[:, lvl], dog[:, lvl - 1]),
                           pick=nxt if lvl == pick_level else None)


def blur_dog_thin(blurs, dogs, kernels, pick_level: int) -> None:
    """Every level of several thin octaves of N frames, in place, in one
    launch. ``blurs``: the octaves' f32[N, L, H, W] stacks in order, each
    at most half the one before, level 0 of the first one filled;
    ``dogs``: their f32[N, L-1, H, W] stacks; ``kernels``: the L-1 full
    symmetric filters of levels 1..L-1. Writes levels 1..L-1 and the DoG
    layers of every octave, and level 0 of each later octave as every
    second pixel of level ``pick_level`` of the octave above. Plain
    version on the CPU, the thin entry of kernel K5 on a CUDA device."""
    global launches_thin
    if not blurs or len(blurs) != len(dogs):
        raise ValueError("blur_dog_thin: one DoG stack per blur stack")
    if blurs[0].device.type == "cpu":
        return blur_dog_thin_torch(blurs, dogs, kernels, pick_level)
    N, L = blurs[0].shape[:2]
    if (len(blurs) > THIN_MAX_OCTAVES or len(kernels) != L - 1
            or not thin_fits(*blurs[0].shape[2:], kernels)):
        raise ValueError(
            f"blur_dog_thin: {len(blurs)} octaves from "
            f"{list(blurs[0].shape)} with {len(kernels)} filters (at most "
            f"{THIN_MAX_OCTAVES} octaves, planes of {THIN_PIXELS} pixels, "
            f"{THIN_MAX_LEVELS} filters of {2 * MAX_S + 1} taps)")
    for b, d in zip(blurs, dogs):
        H, W = b.shape[2:]
        if (b.dtype != torch.float32 or d.dtype != torch.float32
                or tuple(b.shape) != (N, L, H, W)
                or tuple(d.shape) != (N, L - 1, H, W)):
            raise ValueError("blur_dog_thin expects f32[N, L, H, W] and "
                             "f32[N, L-1, H, W] stacks")
    build.require_cuda(NAME_THIN, *blurs, *dogs)
    table = np.asarray([[b.data_ptr(), d.data_ptr(), *b.shape[2:]]
                        for b, d in zip(blurs, dogs)], np.int64)
    spans = np.asarray([(k.shape[0] - 1) // 2 for k in kernels], np.int32)
    taps = np.zeros((L - 1, MAX_S + 1), np.float32)
    for row, k, S in zip(taps, kernels, spans):
        row[:S + 1] = k[S:]
    lib = build.load_library()
    build.launch(
        NAME_THIN, blurs[0], lib.ps_blur_dog_thin,
        table.ctypes.data_as(ctypes.c_void_p), len(blurs), N, L, pick_level,
        taps.ctypes.data_as(ctypes.c_void_p),
        spans.ctypes.data_as(ctypes.c_void_p))
    launches_thin += 1
