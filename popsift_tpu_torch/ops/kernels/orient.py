"""K3: raw 36-bin orientation histograms (csrc/orient.cu).

Replaces popsift_tpu/ops/pallas/orient.py::orientation_hist_pallas.
Per keypoint row: the window of radius r = round(4.5 sigma) around
(round x, round y) on blur level clip(level, 0, L-1); pixels with
|xx - xr| <= r, |yy - yr| <= r, xx in [1, W-2], yy in [1, H-2] and
floor(d^2) <= r^2 add |grad| * exp(floor(d^2) * -0.5 / (sw^2 + 1e-30))
(sw = 1.5 sigma) to bin round(36 (theta + pi) / 2pi) mod 36
(s_orientation.cu:96-134). Rows that are not valid, and rows at or past
``n``, are zero.

:func:`orientation_hist_bucketed` replaces
``orientation_hist_pallas_bucketed`` (orient.py:251): rows with
``sigma <= sigma_split`` in one K3 launch, the rest in another, gathered
back in row order. K3 walks each keypoint's own window, so the buckets
change no block's work, only which launch holds it; the static radii
bound the plain version's window. The extraction path launches K3 once
per octave and does not call it.
"""

from __future__ import annotations

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
launches = 0
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


def orientation_hist(blur, x, y, sigma, level, valid, n: int,
                     radius: int) -> torch.Tensor:
    """f32[K, 36] raw histograms of keypoint rows [0, n) on the octave's
    f32[L, H, W] blur stack: plain version on the CPU, kernel K3 on a
    CUDA device (which needs no static ``radius``: each block walks its
    own keypoint's window)."""
    global launches
    if blur.dim() != 3 or blur.dtype != torch.float32:
        raise ValueError("orientation_hist expects a f32[L, H, W] stack")
    if blur.device.type == "cpu":
        return orientation_hist_torch(blur, x, y, sigma, level, valid, n,
                                      radius)
    x, y, sigma = (t.to(torch.float32).contiguous() for t in (x, y, sigma))
    level = level.to(torch.int32).contiguous()
    valid = valid.to(torch.uint8).contiguous()
    build.require_cuda(NAME, blur, x, y, sigma, level, valid)
    L, H, W = blur.shape
    K = x.shape[0]
    if not 0 <= n <= K:
        raise ValueError(f"orientation_hist: n={n} outside [0, {K}]")
    out = torch.zeros((K, ORI_NBINS), dtype=torch.float32,
                      device=blur.device)
    if n == 0:
        return out
    lib = build.load_library()
    rc = lib.ps_orientation_hist(
        blur.data_ptr(), L, H, W, x.data_ptr(), y.data_ptr(),
        sigma.data_ptr(), level.data_ptr(), valid.data_ptr(), n,
        out.data_ptr(), build.stream_of(blur))
    build.check(rc, NAME)
    launches += 1
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
