"""K3: raw 36-bin orientation histograms (csrc/orient.cu).

Replaces popsift_tpu/ops/pallas/orient.py::orientation_hist_pallas.
Per keypoint row: the window of radius r = round(4.5 sigma) around
(round x, round y) on blur level clip(level, 0, L-1); pixels with
|xx - xr| <= r, |yy - yr| <= r, xx in [1, W-2], yy in [1, H-2] and
floor(d^2) <= r^2 add |grad| * exp(floor(d^2) * -0.5 / (sw^2 + 1e-30))
(sw = 1.5 sigma) to bin round(36 (theta + pi) / 2pi) mod 36
(s_orientation.cu:96-134). Rows that are not valid, and rows at or past
``n``, are zero.

:func:`orientation_hist_octaves` is the entry of the extraction paths:
the rows of all octaves of a frame, or of F frames, in ONE launch. The
kernel reads ``valid`` itself and writes the zeros of the rows that are
not valid, so the output is not filled first and no count is read.
:func:`orientation_hist` launches the same kernel on one octave's rows;
a row's bits do not depend on the launch that holds it.

:func:`orientation_hist_bucketed` replaces
``orientation_hist_pallas_bucketed`` (orient.py:251): rows with
``sigma <= sigma_split`` in one K3 launch, the rest in another, gathered
back in row order. K3 walks each keypoint's own window, so the buckets
change no block's work, only which launch holds it; the static radii
bound the plain version's window. No extraction path calls it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...config import ORI_NBINS, ORI_WINFACTOR
from ...utils.f32 import div
from . import build

NAME = "orientation_hist"
SOURCE = "popsift_tpu_torch/csrc/orient.cu"
REPLACES = "popsift_tpu/ops/pallas/orient.py:183"
NAME_BUCKETED = "orientation_hist_bucketed"
REPLACES_BUCKETED = "popsift_tpu/ops/pallas/orient.py:251"
NAME_OCTAVES = "orientation_hist_octaves"
REPLACES_OCTAVES = REPLACES
MAX_OCTAVES = 16         # MAX_OCT of csrc/orient.cu
launches = 0
launches_octaves = 0
launches_bucketed = 0    # bucketed calls that reached K3 on a CUDA device
# f32 constants of the JAX code (np.float32(math.pi), np.float32(2 pi))
_PI = float(np.float32(math.pi))
_TWO_PI = float(np.float32(2.0 * math.pi))


def _gather_patches(img: torch.Tensor, level: torch.Tensor,
                    cy: torch.Tensor, cx: torch.Tensor, radius: int):
    """[K, P, P] windows (P = 2 radius + 1) of ``img[level]`` placed as
    popsift_tpu.ops.patches.extract_patches places them: origin
    clip(c - radius, 0, max(n, P) - P), cells past the image edge
    replicate it (pad_for_patches). Returns (patches, y0, x0)."""
    L, H, W = img.shape
    P = 2 * radius + 1
    y0 = (cy - radius).clamp(0, max(H, P) - P)
    x0 = (cx - radius).clamp(0, max(W, P) - P)
    ar = torch.arange(P, device=img.device)
    yy = (y0[:, None] + ar).clamp(max=H - 1)
    xx = (x0[:, None] + ar).clamp(max=W - 1)
    lv = level.long().clamp(0, L - 1)
    flat = img.reshape(-1)
    idx = ((lv[:, None, None] * H + yy[:, :, None]) * W + xx[:, None, :])
    return flat[idx], y0, x0


def orientation_hist_torch(blur, x, y, sigma, level, valid, n: int,
                           radius: int, chunk: int = 512) -> torch.Tensor:
    """Plain version: popsift_tpu.ops.orientation._orientation_hist_xla
    (:52-110) on rows [0, n), chunked over rows, with invalid rows
    zeroed. ``radius`` is the static window bound max_ori_radius."""
    L, H, W = blur.shape
    K = x.shape[0]
    out = torch.zeros((K, ORI_NBINS), dtype=torch.float32,
                      device=blur.device)
    R = radius + 1             # +1 margin for the gradient stencil
    P = 2 * R + 1
    ii = torch.arange(P, device=blur.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        xk, yk, sk = x[s:e], y[s:e], sigma[s:e]
        xr = torch.round(xk).long()
        yr = torch.round(yk).long()
        patches, y0, x0 = _gather_patches(blur, level[s:e], yr, xr, R)
        xx = x0[:, None, None] + ii[None, None, :]
        yy = y0[:, None, None] + ii[None, :, None]
        dxv = torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2)
        dyv = torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1)
        grad = torch.sqrt(dxv * dxv + dyv * dyv)
        theta = torch.atan2(dyv, dxv)
        sigw = sk * ORI_WINFACTOR
        rad = torch.round(sigw * 3.0).long()
        factor = torch.div(-0.5, sigw * sigw + 1e-30)
        sq_thres = (rad * rad).float()
        inb = (((xx - xr[:, None, None]).abs() <= rad[:, None, None])
               & ((yy - yr[:, None, None]).abs() <= rad[:, None, None])
               & (xx >= 1) & (xx <= W - 2) & (yy >= 1) & (yy <= H - 2))
        fdx = xx.float() - xk[:, None, None]
        fdy = yy.float() - yk[:, None, None]
        sq = torch.floor(fdx * fdx + fdy * fdy)
        inb &= sq <= sq_thres[:, None, None]
        inb &= valid[s:e, None, None]
        weight = torch.where(inb, grad * torch.exp(sq * factor[:, None, None]),
                             torch.zeros_like(grad))
        bidx = torch.round(div((theta + _PI) * float(ORI_NBINS),
                               _TWO_PI)).long()
        bidx = torch.where(bidx == ORI_NBINS, 0, bidx)
        wflat = weight.reshape(e - s, -1)
        bflat = bidx.reshape(e - s, -1)
        zero = torch.zeros_like(wflat)
        out[s:e] = torch.stack(
            [torch.where(bflat == b, wflat, zero).sum(1)
             for b in range(ORI_NBINS)], dim=1)
    return out


def _launch(name: str, blurs, row_ends, x, y, sigma, level, valid, F: int,
            n_rows: int | None = None) -> torch.Tensor:
    """One launch of K3 over rows [0, n_rows) (default: all K rows) of F
    frames' row arrays; returns f32[K, 36] with the rows past ``n_rows``
    zero. ``level`` is taken as i64 and ``valid`` as one byte a row, the
    types the pipeline holds, so neither is copied."""
    if not 1 <= len(blurs) <= MAX_OCTAVES:
        raise ValueError(f"{name}: {len(blurs)} octaves (1 to {MAX_OCTAVES})")
    x, y, sigma = (t.to(torch.float32).contiguous() for t in (x, y, sigma))
    level = level.to(torch.int64).contiguous()
    valid = (valid.view(torch.uint8) if valid.dtype == torch.bool
             else valid.to(torch.uint8)).contiguous()
    build.require_cuda(name, *blurs, x, y, sigma, level, valid)
    K = x.shape[0]
    n_rows = K if n_rows is None else n_rows
    out = torch.empty((K, ORI_NBINS), dtype=torch.float32, device=x.device)
    if n_rows < K:
        out[n_rows:].zero_()
    if n_rows == 0:
        return out
    # by-value launch table: the stacks stay alive in ``blurs`` and the
    # launch is ordered on the current stream, so raw addresses are safe
    table = np.asarray([[b.data_ptr(), b.shape[0] // F, b.shape[1],
                         b.shape[2], end]
                        for b, end in zip(blurs, row_ends)], np.int64)
    lib = build.load_library()
    build.launch(
        name, x, lib.ps_orientation_hist_octaves,
        table.ctypes.data_as(ctypes.c_void_p), len(blurs), n_rows,
        n_rows // F, x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
        level.data_ptr(), valid.data_ptr(), out.data_ptr())
    return out


def orientation_hist(blur, x, y, sigma, level, valid, n: int,
                     radius: int) -> torch.Tensor:
    """f32[K, 36] raw histograms of keypoint rows [0, n) on the octave's
    f32[L, H, W] blur stack: plain version on the CPU, kernel K3 on a
    CUDA device (which needs no static ``radius``: each warp walks its
    own keypoint's window)."""
    global launches
    if blur.dim() != 3 or blur.dtype != torch.float32:
        raise ValueError("orientation_hist expects a f32[L, H, W] stack")
    if blur.device.type == "cpu":
        return orientation_hist_torch(blur, x, y, sigma, level, valid, n,
                                      radius)
    if not 0 <= n <= x.shape[0]:
        raise ValueError(f"orientation_hist: n={n} outside [0, {x.shape[0]}]")
    out = _launch(NAME, [blur], [n], x, y, sigma, level, valid, 1, n)
    launches += 1 if n else 0
    return out


def _check_octaves(blurs, row_ends, K: int, F: int) -> None:
    if (len(blurs) != len(row_ends) or not blurs or F < 1 or K % F
            or list(row_ends) != sorted(row_ends)
            or row_ends[-1] != K // F):
        raise ValueError(f"orientation_hist_octaves: row ends {row_ends} for "
                         f"{len(blurs)} octaves and {K} rows of {F} frames")
    for b in blurs:
        if b.dim() != 3 or b.dtype != torch.float32 or b.shape[0] % F:
            raise ValueError("orientation_hist_octaves expects f32[F*L, H, W] "
                             "stacks")


def orientation_hist_octaves_torch(blurs, row_ends, x, y, sigma, level, valid,
                                   radius: int, F: int = 1) -> torch.Tensor:
    """Plain version of :func:`orientation_hist_octaves`: per frame and
    octave the valid rows gathered to the front in row order, through
    :func:`orientation_hist_torch`, scattered back."""
    K = x.shape[0]
    _check_octaves(blurs, row_ends, K, F)
    out = torch.zeros((K, ORI_NBINS), dtype=torch.float32, device=x.device)
    for f in range(F):
        start = f * (K // F)
        for blur, end in zip(blurs, row_ends):
            stop = f * (K // F) + end
            L = blur.shape[0] // F
            rows = start + valid[start:stop].nonzero().squeeze(1)
            if rows.numel():
                out[rows] = orientation_hist_torch(
                    blur, x[rows], y[rows], sigma[rows],
                    level[rows].clamp(0, L - 1) + f * L, valid[rows],
                    rows.numel(), radius)
            start = stop
    return out


def orientation_hist_octaves(blurs, row_ends, x, y, sigma, level, valid,
                             radius: int, F: int = 1) -> torch.Tensor:
    """f32[K, 36] raw histograms of the keypoint rows of several octaves
    and F frames in one launch. ``blurs``: the octaves' blur stacks, F
    frames back to back on the layer axis, f32[F*L_o, H_o, W_o];
    ``row_ends``: ascending ends of each octave's rows within a frame's
    K / F rows (the rows are frame-major, each frame's octave segments
    back to back); ``level`` indexes the frame's own L_o layers. Rows
    that are not valid are zero; no count is read back. Plain version on
    the CPU, kernel K3 on a CUDA device (which needs no ``radius``)."""
    global launches_octaves
    _check_octaves(blurs, row_ends, x.shape[0], F)
    if blurs[0].device.type == "cpu":
        return orientation_hist_octaves_torch(blurs, row_ends, x, y, sigma,
                                              level, valid, radius, F)
    out = _launch(NAME_OCTAVES, list(blurs), [int(e) for e in row_ends], x,
                  y, sigma, level, valid, F)
    launches_octaves += 1 if x.shape[0] else 0
    return out


def orientation_hist_bucketed(blur, x, y, sigma, level, valid, radius: int,
                              sigma_split: float, radius_small: int,
                              plain: bool = False) -> torch.Tensor:
    """Radius-bucketed form of :func:`orientation_hist`
    (popsift_tpu/ops/pallas/orient.py:251-289): valid rows with
    ``sigma <= sigma_split`` go through one launch (window bound
    ``radius_small``), the other valid rows through a second (``radius``),
    each packed to the front in row order (nonzero); the histograms are
    scattered back and invalid rows are zero. ``plain`` runs K3's plain
    version per bucket."""
    global launches_bucketed
    K = x.shape[0]
    out = torch.zeros((K, ORI_NBINS), dtype=torch.float32,
                      device=blur.device)
    valid = valid.bool()
    small = valid & (sigma <= sigma_split)
    before = launches
    fn = orientation_hist_torch if plain else orientation_hist
    for m, rad in ((small, radius_small), (valid & ~small, radius)):
        rows = m.nonzero().squeeze(1)
        n = rows.numel()
        if n:
            out[rows] = fn(blur, x[rows], y[rows], sigma[rows], level[rows],
                           valid[rows], n, rad)
    launches_bucketed += 1 if launches > before else 0
    return out
