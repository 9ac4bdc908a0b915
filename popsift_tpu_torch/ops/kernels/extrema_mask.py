"""K1: 26-neighbour DoG extremum mask (csrc/extrema_mask.cu).

Replaces popsift_tpu/ops/pallas/extrema_mask.py::candidate_mask_canvas_pallas
and the dense ``candidate_mask_pallas`` (the same mask, which the port
always reads from a dense stack). For DoG layers 1..D-2 of a dense
octave stack f32[D, H, W], marks the pixels with |c| >= thr1 that are
strictly greater, or strictly smaller, than all 26 neighbours. Border
pixels are false (with edge-replicated neighbours they can never be
strict extrema).

:func:`candidate_mask_octaves` is the entry of the extraction paths: the
masks of all octaves of a frame, or of F frames, in ONE launch, returned
as ``torch.bool`` views of the kernel's 0/1 bytes (no copy).
:func:`candidate_mask` (one octave) and :func:`candidate_mask_batched`
(one octave of F frames' stacks back to back, f32[F*D, H, W], replacing
``candidate_mask_canvas_batched``) launch the same kernel on a table of
one octave; each entry has its own launch counter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

NAME = "extrema_mask"
SOURCE = "popsift_tpu_torch/csrc/extrema_mask.cu"
REPLACES = "popsift_tpu/ops/pallas/extrema_mask.py:265"
NAME_BATCHED = "extrema_mask_batched"
REPLACES_BATCHED = "popsift_tpu/ops/pallas/extrema_mask.py:383"
NAME_OCTAVES = "extrema_mask_octaves"
REPLACES_OCTAVES = REPLACES
MAX_OCTAVES = 16         # MAX_OCT of csrc/extrema_mask.cu
launches = 0
launches_batched = 0
launches_octaves = 0


def _neighbor_offsets():
    return [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1) if dz or dy or dx]


def candidate_mask_torch(dog: torch.Tensor, thr1: float) -> torch.Tensor:
    """Plain version: the XLA twin (popsift_tpu/ops/extrema.py:115-125)
    over an edge-padded copy. Returns uint8 [D-2, H, W]."""
    D, H, W = dog.shape
    Z = D - 2
    c = dog[1:Z + 1]
    first = c.abs() >= thr1
    zi = torch.arange(-1, D + 1, device=dog.device).clamp_(0, D - 1)
    yi = torch.arange(-1, H + 1, device=dog.device).clamp_(0, H - 1)
    xi = torch.arange(-1, W + 1, device=dog.device).clamp_(0, W - 1)
    dogp = dog[zi][:, yi][:, :, xi]
    gt = torch.ones_like(c, dtype=torch.bool)
    lt = torch.ones_like(c, dtype=torch.bool)
    for dz, dy, dx in _neighbor_offsets():
        nb = dogp[2 + dz:2 + dz + Z, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        gt &= c > nb
        lt &= c < nb
    return (first & (gt | lt)).to(torch.uint8)


def _check(dog: torch.Tensor, F: int, who: str) -> None:
    if (dog.dim() != 3 or F < 1 or dog.shape[0] % F
            or dog.shape[0] // F < 3 or dog.dtype != torch.float32):
        raise ValueError(f"{who} expects f32[F*D, H, W] with D >= 3")


def _launch(name: str, dogs, F: int, thr1: float) -> list:
    """One launch of K1 over the octaves ``dogs`` (each f32[F*D_o, H_o,
    W_o]); returns their uint8 [F, D_o-2, H_o, W_o] masks."""
    if not 1 <= len(dogs) <= MAX_OCTAVES:
        raise ValueError(f"{name}: {len(dogs)} octaves (1 to {MAX_OCTAVES})")
    build.require_cuda(name, *dogs)
    outs = [torch.empty((F, d.shape[0] // F - 2, d.shape[1], d.shape[2]),
                        dtype=torch.uint8, device=d.device) for d in dogs]
    # by-value launch table: the stacks stay alive in ``dogs`` and the
    # launch is ordered on the current stream, so raw addresses are safe
    table = np.asarray([[d.data_ptr(), o.data_ptr(), d.shape[0] // F,
                         d.shape[1], d.shape[2]]
                        for d, o in zip(dogs, outs)], np.int64)
    lib = build.load_library()
    build.launch(
        name, dogs[0], lib.ps_extrema_mask_octaves,
        table.ctypes.data_as(ctypes.c_void_p), len(dogs), F, float(thr1))
    return outs


def candidate_mask(dog: torch.Tensor, thr1: float) -> torch.Tensor:
    """uint8 [D-2, H, W] candidate mask of a dense f32[D, H, W] DoG
    stack: plain version on the CPU, kernel K1 on a CUDA device."""
    global launches
    _check(dog, 1, "candidate_mask")
    if dog.device.type == "cpu":
        return candidate_mask_torch(dog, thr1)
    out = _launch(NAME, [dog], 1, thr1)[0][0]
    launches += 1
    return out


def candidate_mask_batched_torch(dog: torch.Tensor, F: int,
                                 thr1: float) -> torch.Tensor:
    """Plain version of the batched entry: :func:`candidate_mask_torch`
    on each frame's own D layers. Returns uint8 [F, D-2, H, W]."""
    D = dog.shape[0] // F
    return torch.stack([candidate_mask_torch(dog[f * D:(f + 1) * D], thr1)
                        for f in range(F)])


def candidate_mask_batched(dog: torch.Tensor, F: int,
                           thr1: float) -> torch.Tensor:
    """uint8 [F, D-2, H, W] candidate masks of F frames' dense DoG
    stacks stacked on the layer axis, f32[F*D, H, W]: plain version on
    the CPU, one launch of kernel K1 for all frames on a CUDA device."""
    global launches_batched
    _check(dog, F, "candidate_mask_batched")
    if dog.device.type == "cpu":
        return candidate_mask_batched_torch(dog, F, thr1)
    out = _launch(NAME_BATCHED, [dog], F, thr1)[0]
    launches_batched += 1
    return out


def candidate_mask_octaves_torch(dogs, thr1: float, F: int = 1) -> list:
    """Plain version of :func:`candidate_mask_octaves`:
    :func:`candidate_mask_batched_torch` per octave, as bool."""
    return [candidate_mask_batched_torch(d, F, thr1).view(torch.bool)
            for d in dogs]


def candidate_mask_octaves(dogs, thr1: float, F: int = 1) -> list:
    """bool [F, D_o-2, H_o, W_o] candidate masks of the octaves ``dogs``
    (each the dense DoG stacks of F frames back to back on the layer
    axis, f32[F*D_o, H_o, W_o]): plain version on the CPU, ONE launch of
    kernel K1 for all octaves and frames on a CUDA device. The masks are
    views of the kernel's bytes as ``torch.bool``."""
    global launches_octaves
    for d in dogs:
        _check(d, F, "candidate_mask_octaves")
    if dogs[0].device.type == "cpu":
        return candidate_mask_octaves_torch(dogs, thr1, F)
    outs = [o.view(torch.bool) for o in _launch(NAME_OCTAVES, list(dogs), F,
                                                thr1)]
    launches_octaves += 1
    return outs
