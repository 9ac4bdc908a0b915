"""K4: loop-variant SIFT descriptors (csrc/desc.cu).

Replaces popsift_tpu/ops/pallas/desc.py::descriptor_loop_pallas_dma. Per
(keypoint, orientation) job, every pixel of the job's window inside
[1, W-2] x [1, H-2] adds its central-difference gradient, rotated by the
job angle and scaled by 1/(3 sigma), under the envelope
exp(-(nx^2 + ny^2)/8), with triangular weights to the 4x4 tile centres
at -1.5..1.5 and a linear split into 8 angle bins
(popsift_tpu/ops/descriptors.py:392-473, s_desc_loop.cu:19-138). Output
is f32[F, 128] in (ty, tx, b) order, not normalized. Invalid jobs, jobs
with sigma 0 and rows at or past ``n`` are zero.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...config import DESC_BINS, DESC_MAGNIFY
from . import build
from .orient import _gather_patches

NAME = "descriptor_loop"
SOURCE = "popsift_tpu_torch/csrc/desc.cu"
REPLACES = "popsift_tpu/ops/pallas/desc.py:318"
launches = 0
_TWO_PI = float(np.float32(2.0 * math.pi))
_FOUR_OVER_PI = float(np.float32(4.0 / math.pi))


def descriptor_loop_torch(blur, x, y, sigma, level, ang, valid, n: int,
                          radius: int, chunk: int = 256) -> torch.Tensor:
    """Plain version: popsift_tpu.ops.descriptors._descriptor_loop_chunk
    over jobs [0, n), chunked over jobs (descriptors.py:563), with the
    static window of ``radius`` (loop_patch_radius)."""
    L, H, W = blur.shape
    F = x.shape[0]
    out = torch.zeros((F, 128), dtype=torch.float32, device=blur.device)
    P = 2 * radius + 1
    ii = torch.arange(P, device=blur.device)
    centers = torch.arange(4, dtype=torch.float32, device=blur.device) - 1.5
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        m = e - s
        xk, yk, sk, ak = x[s:e], y[s:e], sigma[s:e], ang[s:e]
        xr = torch.round(xk).long()
        yr = torch.round(yk).long()
        patches, y0, x0 = _gather_patches(blur, level[s:e], yr, xr, radius)
        px = x0[:, None, None] + ii[None, None, :]
        py = y0[:, None, None] + ii[None, :, None]
        # border cells of the window are outside every valid support, so
        # the circular roll is the JAX twin's gradient exactly
        dxv = torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2)
        dyv = torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1)
        mod = torch.sqrt(dxv * dxv + dyv * dyv)
        th = torch.atan2(dyv, dxv)

        sbp = (sk * DESC_MAGNIFY).abs()
        pos = sbp > 0
        inv_sbp = torch.where(pos, torch.reciprocal(
            torch.where(pos, sbp, torch.ones_like(sbp))),
            torch.zeros_like(sbp))
        crsbp = (torch.cos(ak) * inv_sbp)[:, None, None]
        srsbp = (torch.sin(ak) * inv_sbp)[:, None, None]
        fdx = px.float() - xk[:, None, None]
        fdy = py.float() - yk[:, None, None]
        nxg = crsbp * fdx + srsbp * fdy
        nyg = crsbp * fdy - srsbp * fdx
        inb = (px >= 1) & (px <= W - 2) & (py >= 1) & (py <= H - 2)

        tha = th - ak[:, None, None]
        tha = torch.where(tha < 0.0, tha + _TWO_PI, tha)
        tha = torch.where(tha >= _TWO_PI, tha - _TWO_PI, tha)
        tth = tha * _FOUR_OVER_PI
        fo_f = torch.floor(tth)
        frac = tth - fo_f
        fo = fo_f.long()
        fo0 = torch.remainder(fo, DESC_BINS)
        fo1 = torch.remainder(fo + 1, DESC_BINS)

        ww = torch.exp((nxg * nxg + nyg * nyg) * -0.125)
        wgt = torch.where(inb, ww * mod, torch.zeros_like(mod))
        ax = (nxg[..., None] - centers).abs()               # [m, P, P, 4]
        ay = (nyg[..., None] - centers).abs()
        zero4 = torch.zeros_like(ax)
        wx = torch.where(ax < 1.0, 1.0 - ax, zero4).reshape(m, P * P, 4)
        wy = torch.where(ay < 1.0, 1.0 - ay, zero4).reshape(m, P * P, 4)

        wgt_f = wgt.reshape(m, P * P)
        fo0f = fo0.reshape(m, P * P)
        fo1f = fo1.reshape(m, P * P)
        fracf = frac.reshape(m, P * P)
        zero = torch.zeros_like(fracf)
        cols = []
        for b in range(DESC_BINS):
            cb = wgt_f * (torch.where(fo0f == b, 1.0 - fracf, zero)
                          + torch.where(fo1f == b, fracf, zero))
            # desc_b[ty, tx] = sum_p (wy[p, ty] cb[p]) wx[p, tx]
            cols.append(torch.einsum("fpi,fpj->fij", wy * cb[..., None],
                                     wx))
        desc = torch.stack(cols, dim=-1).reshape(m, 128)
        keep = pos & valid[s:e]
        out[s:e] = torch.where(keep[:, None], desc, torch.zeros_like(desc))
    return out


def descriptor_loop(blur, x, y, sigma, level, ang, valid, n: int,
                    radius: int) -> torch.Tensor:
    """f32[F, 128] raw descriptors of jobs [0, n) on the octave's
    f32[L, H, W] blur stack: plain version on the CPU, kernel K4 on a
    CUDA device. ``radius`` is the static window bound of the JAX twin
    (loop_patch_radius); the kernel intersects it with each job's own
    support."""
    global launches
    if blur.dim() != 3 or blur.dtype != torch.float32:
        raise ValueError("descriptor_loop expects a f32[L, H, W] stack")
    if blur.device.type == "cpu":
        return descriptor_loop_torch(blur, x, y, sigma, level, ang, valid,
                                     n, radius)
    x, y, sigma, ang = (t.to(torch.float32).contiguous()
                        for t in (x, y, sigma, ang))
    level = level.to(torch.int32).contiguous()
    valid = valid.to(torch.uint8).contiguous()
    build.require_cuda(NAME, blur, x, y, sigma, level, ang, valid)
    L, H, W = blur.shape
    F = x.shape[0]
    if not 0 <= n <= F:
        raise ValueError(f"descriptor_loop: n={n} outside [0, {F}]")
    out = torch.zeros((F, 128), dtype=torch.float32, device=blur.device)
    if n == 0:
        return out
    lib = build.load_library()
    rc = lib.ps_descriptor_loop(
        blur.data_ptr(), L, H, W, x.data_ptr(), y.data_ptr(),
        sigma.data_ptr(), level.data_ptr(), ang.data_ptr(),
        valid.data_ptr(), n, radius, out.data_ptr(), build.stream_of(blur))
    build.check(rc, NAME)
    launches += 1
    return out
