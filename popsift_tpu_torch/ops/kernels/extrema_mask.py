"""K1: 26-neighbour DoG extremum mask (csrc/extrema_mask.cu).

Replaces popsift_tpu/ops/pallas/extrema_mask.py::candidate_mask_canvas_pallas
and the dense ``candidate_mask_pallas`` (the same mask, which the port
always reads from a dense stack). For DoG layers 1..D-2 of a dense
octave stack f32[D, H, W], marks the pixels with |c| >= thr1 that are
strictly greater, or strictly smaller, than all 26 neighbours. Border
pixels are false (with edge-replicated neighbours they can never be
strict extrema).

The frame-batched entry (:func:`candidate_mask_batched`, replacing
``candidate_mask_canvas_batched``) takes F frames' stacks back to back,
f32[F*D, H, W], in one launch, with its own launch counter.
"""

from __future__ import annotations

import torch

from . import build

NAME = "extrema_mask"
SOURCE = "popsift_tpu_torch/csrc/extrema_mask.cu"
REPLACES = "popsift_tpu/ops/pallas/extrema_mask.py:265"
NAME_BATCHED = "extrema_mask_batched"
REPLACES_BATCHED = "popsift_tpu/ops/pallas/extrema_mask.py:383"
launches = 0
launches_batched = 0


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


def candidate_mask(dog: torch.Tensor, thr1: float) -> torch.Tensor:
    """uint8 [D-2, H, W] candidate mask of a dense f32[D, H, W] DoG
    stack: plain version on the CPU, kernel K1 on a CUDA device."""
    global launches
    if dog.dim() != 3 or dog.shape[0] < 3 or dog.dtype != torch.float32:
        raise ValueError("candidate_mask expects f32[D >= 3, H, W]")
    if dog.device.type == "cpu":
        return candidate_mask_torch(dog, thr1)
    build.require_cuda(NAME, dog)
    D, H, W = dog.shape
    out = torch.empty((D - 2, H, W), dtype=torch.uint8, device=dog.device)
    lib = build.load_library()
    rc = lib.ps_extrema_mask(dog.data_ptr(), out.data_ptr(), D, H, W,
                             float(thr1), build.stream_of(dog))
    build.check(rc, NAME)
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
    if (dog.dim() != 3 or F < 1 or dog.shape[0] % F
            or dog.shape[0] // F < 3 or dog.dtype != torch.float32):
        raise ValueError("candidate_mask_batched expects f32[F*D, H, W] "
                         "with D >= 3")
    if dog.device.type == "cpu":
        return candidate_mask_batched_torch(dog, F, thr1)
    build.require_cuda(NAME_BATCHED, dog)
    FD, H, W = dog.shape
    D = FD // F
    out = torch.empty((F, D - 2, H, W), dtype=torch.uint8, device=dog.device)
    lib = build.load_library()
    rc = lib.ps_extrema_mask_batched(dog.data_ptr(), out.data_ptr(), F, D, H,
                                     W, float(thr1), build.stream_of(dog))
    build.check(rc, NAME_BATCHED)
    launches_batched += 1
    return out
