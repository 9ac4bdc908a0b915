"""K7: fused chain of blur levels and their DoGs (csrc/blur_chain.cu).

Replaces popsift_tpu/ops/pallas/blur.py::octave_blur_chain. Given level
l0 - 1 of N planes, f32[N, H, W], and the full symmetric 1-D filters of
the next n levels, returns those levels and their DoGs, f32[N, n, H, W]
each: ``blurs[:, i]`` is level l0 + i (the separable blur of the level
before it, edge-replicated at every level) and ``dogs[:, i]`` is that
level minus the one before. ``group`` caps the levels fused into one
launch; the next group starts from the last level of the one before, as
in the JAX function. One launch covers all N planes. ``pick`` takes
every second pixel of one level (the next octave's level 0) from the
launch that writes that level.

Every level equals kernel K5's (ops/kernels/blur_dog.py) bit for bit:
the plain version is the chain of K5's plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .blur_dog import MAX_S, _check_planes, blur_dog_torch

NAME = "blur_chain"
SOURCE = "popsift_tpu_torch/csrc/blur_chain.cu"
REPLACES = "popsift_tpu/ops/pallas/blur.py:320"
MAX_LEVELS = 5      # csrc/blur_chain.cu MAX_LEVELS
launches = 0


def _alloc(src: torch.Tensor, n: int, out):
    if out is not None:
        return out
    N, H, W = src.shape
    return (torch.empty((N, n, H, W), dtype=torch.float32, device=src.device),
            torch.empty((N, n, H, W), dtype=torch.float32, device=src.device))


def blur_chain_torch(src: torch.Tensor, kernels, out=None, pick=None,
                     pick_level: int = 0):
    """Plain version: the level-by-level chain of ``blur_dog_torch``.
    ``out`` = (blurs, dogs) f32[N, n, H, W] tensors to write into;
    ``pick`` f32[N, oh, ow] takes every second pixel of level
    ``pick_level`` of the chain."""
    blurs, dogs = _alloc(src, len(kernels), out)
    prev = src
    for i, k in enumerate(kernels):
        blur_dog_torch(prev, k, out=(blurs[:, i], dogs[:, i]),
                       pick=pick if i == pick_level else None)
        prev = blurs[:, i]
    return blurs, dogs


def _check_levels(name: str, t: torch.Tensor, shape) -> None:
    """[N, n, H, W] f32 with dense [H, W] planes (plane and level strides
    are free, so a run of levels of a [N, L, H, W] stack qualifies)."""
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected f32{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name}: each [H, W] plane must be contiguous")


def blur_chain(src: torch.Tensor, kernels, group: int | None = None,
               out=None, pick=None, pick_level: int = 0):
    """(blurs, dogs) f32[N, n, H, W] of the n = len(kernels) levels that
    follow ``src`` f32[N, H, W]: plain version on the CPU, kernel K7 on a
    CUDA device, one launch per group of at most ``group`` levels (None:
    all of them, at most 5). ``out`` = (blurs, dogs) tensors to write
    into (planes and levels may be strided); allocated if None.
    ``pick`` f32[N, oh, ow] (oh <= ceil(H/2), ow <= ceil(W/2), planes may
    be strided) takes ``blurs[:, pick_level, 2y, 2x]`` from the launch
    that writes that level."""
    global launches
    if src.dim() != 3:
        raise ValueError("blur_chain expects f32[N, H, W] planes")
    n = len(kernels)
    if n < 1:
        raise ValueError("blur_chain needs at least one level")
    if pick is not None and not 0 <= pick_level < n:
        raise ValueError(f"blur_chain: pick level {pick_level} of {n}")
    if src.device.type == "cpu":
        return blur_chain_torch(src, kernels, out, pick, pick_level)
    group = n if group is None else max(1, min(group, n))
    if group > MAX_LEVELS:
        raise ValueError(f"blur_chain: at most {MAX_LEVELS} levels a launch")
    N, H, W = src.shape
    blurs, dogs = _alloc(src, n, out)
    _check_planes("blur_chain src", src, (N, H, W))
    for nm, t in (("blurs", blurs), ("dogs", dogs)):
        _check_levels(f"blur_chain {nm}", t, (N, n, H, W))
    oh = ow = 0
    if pick is not None:
        oh, ow = pick.shape[-2:]
        if pick.dim() != 3 or oh > (H + 1) // 2 or ow > (W + 1) // 2:
            raise ValueError(f"blur_chain pick: {list(pick.shape)} does not "
                             f"fit every second pixel of {[N, H, W]}")
        _check_planes("blur_chain pick", pick, (N, oh, ow))
    for t in (src, blurs, dogs) + (() if pick is None else (pick,)):
        if t.device != src.device or t.device.type != "cuda":
            raise ValueError("blur_chain: every tensor must be on one CUDA "
                             f"device (got {t.device})")
    spans = [(k.shape[0] - 1) // 2 for k in kernels]
    for k, S in zip(kernels, spans):
        if k.shape[0] != 2 * S + 1 or S > MAX_S:
            raise ValueError(f"blur_chain: filter of {k.shape[0]} taps "
                             f"(odd, at most {2 * MAX_S + 1})")
    lib = build.load_library()
    prev = src
    for g0 in range(0, n, group):
        g1 = min(n, g0 + group)
        T = lib.ps_blur_chain_tile(N, H, W, sum(spans[g0:g1]))
        if T == 0:
            raise ValueError(
                f"blur_chain: the halo of levels {g0}..{g1 - 1} "
                f"({sum(spans[g0:g1])} pixels a side) does not fit a "
                f"block's shared memory; use a smaller group")
        taps = np.ascontiguousarray(np.concatenate(
            [kernels[i][spans[i]:] for i in range(g0, g1)]), dtype=np.float32)
        sp = np.asarray(spans[g0:g1], dtype=np.int32)
        b, d = blurs[:, g0:g1], dogs[:, g0:g1]
        pk = pick if pick is not None and g0 <= pick_level < g1 else None
        build.launch(
            NAME, src, lib.ps_blur_chain,
            prev.data_ptr(), prev.stride(0), b.data_ptr(), b.stride(0),
            b.stride(1), d.data_ptr(), d.stride(0), d.stride(1),
            None if pk is None else pk.data_ptr(),
            0 if pk is None else pk.stride(0), oh, ow, pick_level - g0,
            N, H, W, taps.ctypes.data_as(ctypes.c_void_p),
            sp.ctypes.data_as(ctypes.c_void_p), g1 - g0, T)
        launches += 1
        prev = blurs[:, g1 - 1]
    return blurs, dogs
