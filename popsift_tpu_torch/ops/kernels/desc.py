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

The kernel gathers by tile: a block of 16 warps takes a job, the block
stages each support pixel's terms once in shared memory, and the warp of
tile (ty, tx) walks only the box of pixels that can reach its tile
(:func:`tile_boxes` is the same box in numpy) and sums 8 angle bins in
registers, in an order fixed by the code (csrc/desc.cu has the design
note). :func:`descriptor_loop_octaves` runs the job rows of all octaves
of a frame, or of a batch, in ONE launch; :func:`descriptor_loop` is the
same kernel on one octave.

Two more entries close the JAX package's descriptor kernels:

* :func:`descriptor_loop_patches` replaces ``descriptor_loop_pallas``
  (desc.py:192): the same kernel on pre-cut windows f32[F, P, PL] with
  their origins (``ops/patches.py::extract_patches_rect`` cuts them),
  gradients by central differences with zeros beyond the patch edge;
* :func:`descriptor_loop_multibucket` / :func:`descriptor_loop_bucketed`
  replace ``descriptor_loop_pallas_multibucket`` / ``_bucketed``
  (desc.py:383, :439): jobs routed by sigma into ascending
  ``(sigma_hi, radius)`` buckets, one K4 launch per bucket with that
  bucket's window radius, gathered back in row order. The extraction
  path launches K4 once per frame or batch and does not call them.

Row bounds: on a spatially sharded row band (``parallel/spatial.py``)
each octave of :func:`descriptor_loop_octaves` takes the global row of
its stack's row 0 (``y_offsets``) and inclusive global scan rows in
place of ``(1, H-2)`` (``y_bounds``), in the scan bound only (the static
window's origin stays local to the stack), as JAX's
``_descriptor_loop_chunk(y_bounds=)`` (descriptors.py:392-436) with the
keypoints left in global coordinates (orient.py's docstring says why).
Such a call counts in ``launches_octaves_bounded``
(``descriptor_loop_octaves_bounded``); without bounds it is today's
launch, bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...config import DESC_BINS, DESC_MAGNIFY
from . import build
from .orient import _gather_patches, row_specs

NAME = "descriptor_loop"
SOURCE = "popsift_tpu_torch/csrc/desc.cu"
REPLACES = "popsift_tpu/ops/pallas/desc.py:318"
NAME_OCTAVES = "descriptor_loop_octaves"
REPLACES_OCTAVES = REPLACES     # the same TPU kernel, once per octave there
NAME_OCTAVES_BOUNDED = "descriptor_loop_octaves_bounded"
REPLACES_OCTAVES_BOUNDED = REPLACES
NAME_PATCHES = "descriptor_loop_patches"
REPLACES_PATCHES = "popsift_tpu/ops/pallas/desc.py:192"
NAME_BUCKETED = "descriptor_loop_bucketed"
REPLACES_BUCKETED = "popsift_tpu/ops/pallas/desc.py:383"
MAX_OCTAVES = 16    # csrc/desc.cu MAX_OCT
launches = 0
launches_octaves = 0
launches_octaves_bounded = 0
launches_patches = 0
launches_bucketed = 0    # bucketed calls that reached K4 on a CUDA device
_TWO_PI = float(np.float32(2.0 * math.pi))
_FOUR_OVER_PI = float(np.float32(4.0 / math.pi))


def _loop_terms(dxv, dyv, px, py, xk, yk, sk, ak, valid, H: int, W: int,
                y_bounds=None) -> torch.Tensor:
    """f32[m, 128] loop descriptors of m jobs from their windows' pixel
    gradients ``dxv``/``dyv`` f32[m, P, PL] and pixel coordinates
    ``px`` i64[m, 1, PL] / ``py`` i64[m, P, 1]:
    popsift_tpu.ops.descriptors._descriptor_loop_chunk (:416-473) after
    the gradient, the same for every way of cutting the window.
    ``y_bounds``: the inclusive scan rows, by default (1, H-2)."""
    y_lo, y_hi = (1, H - 2) if y_bounds is None else y_bounds
    m, P, PL = dxv.shape
    centers = torch.arange(4, dtype=torch.float32, device=dxv.device) - 1.5
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
    inb = (px >= 1) & (px <= W - 2) & (py >= y_lo) & (py <= y_hi)

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
    ax = (nxg[..., None] - centers).abs()               # [m, P, PL, 4]
    ay = (nyg[..., None] - centers).abs()
    zero4 = torch.zeros_like(ax)
    wx = torch.where(ax < 1.0, 1.0 - ax, zero4).reshape(m, P * PL, 4)
    wy = torch.where(ay < 1.0, 1.0 - ay, zero4).reshape(m, P * PL, 4)

    wgt_f = wgt.reshape(m, P * PL)
    fo0f = fo0.reshape(m, P * PL)
    fo1f = fo1.reshape(m, P * PL)
    fracf = frac.reshape(m, P * PL)
    zero = torch.zeros_like(fracf)
    cols = []
    for b in range(DESC_BINS):
        cb = wgt_f * (torch.where(fo0f == b, 1.0 - fracf, zero)
                      + torch.where(fo1f == b, fracf, zero))
        # desc_b[ty, tx] = sum_p (wy[p, ty] cb[p]) wx[p, tx]
        cols.append(torch.einsum("fpi,fpj->fij", wy * cb[..., None], wx))
    desc = torch.stack(cols, dim=-1).reshape(m, 128)
    keep = pos & valid
    return torch.where(keep[:, None], desc, torch.zeros_like(desc))


def descriptor_loop_torch(blur, x, y, sigma, level, ang, valid, n: int,
                          radius: int, chunk: int = 256, y_off: int = 0,
                          y_bounds=None) -> torch.Tensor:
    """Plain version: popsift_tpu.ops.descriptors._descriptor_loop_chunk
    over jobs [0, n), chunked over jobs (descriptors.py:563), with the
    static window of ``radius`` (loop_patch_radius). The stack's row 0 is
    global row ``y_off``, ``y`` is global and ``y_bounds`` the inclusive
    global scan rows (default (1, H-2))."""
    L, H, W = blur.shape
    F = x.shape[0]
    out = torch.zeros((F, 128), dtype=torch.float32, device=blur.device)
    P = 2 * radius + 1
    ii = torch.arange(P, device=blur.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        xr = torch.round(x[s:e]).long()
        yr = torch.round(y[s:e]).long()
        patches, y0, x0 = _gather_patches(blur, level[s:e], yr - y_off, xr,
                                          radius)
        px = x0[:, None, None] + ii[None, None, :]
        py = y0[:, None, None] + ii[None, :, None] + y_off     # global rows
        # border cells of the window are outside every valid support, so
        # the circular roll is the JAX twin's gradient exactly
        dxv = torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2)
        dyv = torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1)
        out[s:e] = _loop_terms(dxv, dyv, px, py, x[s:e], y[s:e], sigma[s:e],
                               ang[s:e], valid[s:e], H, W, y_bounds)
    return out


def tile_boxes(x, y, sigma, ang):
    """The pixel boxes the kernel's tile warps walk, before clipping to
    the scan bounds: numpy model of csrc/desc.cu, same formula in f32.
    For jobs ``x, y, sigma, ang`` f32[F] returns integer arrays
    ``(x_lo, x_hi, y_lo, y_hi)`` [F, 4, 4] indexed (ty, tx), inclusive
    image coordinates. Tile (ty, tx) takes weight only from pixels with
    |nx - (tx - 1.5)| < 1 and |ny - (ty - 1.5)| < 1, a rotated square of
    half-side SBP = 3 sigma around kp + SBP R(ang) (tx - 1.5, ty - 1.5);
    the box is its axis-aligned hull, half-side SBP (|cos| + |sin|),
    plus one pixel for the rounding of the f32 terms."""
    f32 = np.float32
    x, y, sigma, ang = (np.asarray(a, f32) for a in (x, y, sigma, ang))
    sbp = np.abs(f32(3.0) * sigma)[:, None, None]
    ca = np.cos(ang).astype(f32)[:, None, None]
    sa = np.sin(ang).astype(f32)[:, None, None]
    cent = np.arange(4, dtype=f32) - f32(1.5)
    cx, cy = cent[None, None, :], cent[None, :, None]
    half = sbp * (np.abs(ca) + np.abs(sa)) + f32(1.0)
    tcx = x[:, None, None] + sbp * (ca * cx - sa * cy)
    tcy = y[:, None, None] + sbp * (sa * cx + ca * cy)
    return (np.floor(tcx - half).astype(np.int64),
            np.ceil(tcx + half).astype(np.int64),
            np.floor(tcy - half).astype(np.int64),
            np.ceil(tcy + half).astype(np.int64))


def _kernel_args(x, y, sigma, level, ang, valid):
    """The job arrays in the kernel's types, contiguous."""
    x, y, sigma, ang = (t.to(torch.float32).contiguous()
                        for t in (x, y, sigma, ang))
    level = level.to(torch.int32).contiguous()
    valid = valid.to(torch.uint8).contiguous()
    return x, y, sigma, level, ang, valid


def descriptor_loop_octaves_torch(blurs, row_ends, x, y, sigma, level, ang,
                                  valid, radius: int, y_offsets=None,
                                  y_bounds=None) -> torch.Tensor:
    """Plain version of :func:`descriptor_loop_octaves`: per octave the
    valid rows gathered to the front in row order, through
    :func:`descriptor_loop_torch`, scattered back."""
    specs = row_specs(NAME_OCTAVES, blurs, y_offsets, y_bounds)
    out = torch.zeros((x.shape[0], 128), dtype=torch.float32,
                      device=x.device)
    start = 0
    for o, (blur, end) in enumerate(zip(blurs, row_ends)):
        rows = start + valid[start:end].nonzero().squeeze(1)
        if rows.numel():
            out[rows] = descriptor_loop_torch(
                blur, x[rows], y[rows], sigma[rows], level[rows], ang[rows],
                valid[rows], rows.numel(), radius, y_off=specs[o][0],
                y_bounds=specs[o][1:])
        start = end
    return out


def descriptor_loop_octaves(blurs, row_ends, x, y, sigma, level, ang, valid,
                            radius: int, y_offsets=None,
                            y_bounds=None) -> torch.Tensor:
    """f32[F, 128] raw descriptors of the job rows of several octaves in
    one launch. ``blurs``: the octaves' f32[L_o, H_o, W_o] blur stacks;
    ``row_ends``: ascending ends of each octave's rows in the job arrays
    (octave o owns rows [row_ends[o-1], row_ends[o]), the last is F);
    ``level`` indexes the octave's own stack (a batch adds ``frame * L``).
    A row band's octave gives the global row of its stack's row 0
    (``y_offsets``) and inclusive global scan rows (``y_bounds``); see
    the module docstring. Rows that are not valid are zero; no count is
    read back. Plain version on the CPU, kernel K4 on a CUDA device."""
    global launches_octaves, launches_octaves_bounded
    F = x.shape[0]
    if len(blurs) != len(row_ends) or not blurs or list(row_ends) != sorted(
            row_ends) or row_ends[-1] != F:
        raise ValueError(f"descriptor_loop_octaves: row ends {row_ends} for "
                         f"{len(blurs)} octaves and {F} rows")
    for b in blurs:
        if b.dim() != 3 or b.dtype != torch.float32:
            raise ValueError("descriptor_loop_octaves expects f32[L, H, W] "
                             "stacks")
    specs = row_specs(NAME_OCTAVES, blurs, y_offsets, y_bounds)
    if blurs[0].device.type == "cpu":
        return descriptor_loop_octaves_torch(blurs, row_ends, x, y, sigma,
                                             level, ang, valid, radius,
                                             y_offsets, y_bounds)
    if len(blurs) > MAX_OCTAVES:
        raise ValueError(f"descriptor_loop_octaves: {len(blurs)} octaves "
                         f"(at most {MAX_OCTAVES})")
    x, y, sigma, level, ang, valid = _kernel_args(
        x, y, sigma, level, ang, valid)
    build.require_cuda(NAME_OCTAVES, *blurs, x, y, sigma, level, ang, valid)
    out = torch.zeros((F, 128), dtype=torch.float32, device=x.device)
    if F == 0:
        return out
    # by-value launch table: the stacks stay alive in ``blurs`` and the
    # launch is ordered on the current stream, so raw addresses are safe
    bounded = y_offsets is not None or y_bounds is not None
    table = np.asarray([[b.data_ptr(), *b.shape, end, *spec]
                        for b, end, spec in zip(blurs, row_ends, specs)],
                       np.int64)
    lib = build.load_library()
    build.launch(
        NAME_OCTAVES_BOUNDED if bounded else NAME_OCTAVES, x,
        lib.ps_descriptor_loop_octaves,
        table.ctypes.data_as(ctypes.c_void_p), len(blurs), x.data_ptr(),
        y.data_ptr(), sigma.data_ptr(), level.data_ptr(), ang.data_ptr(),
        valid.data_ptr(), radius, out.data_ptr())
    if bounded:
        launches_octaves_bounded += 1
    else:
        launches_octaves += 1
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
    x, y, sigma, level, ang, valid = _kernel_args(
        x, y, sigma, level, ang, valid)
    build.require_cuda(NAME, blur, x, y, sigma, level, ang, valid)
    L, H, W = blur.shape
    F = x.shape[0]
    if not 0 <= n <= F:
        raise ValueError(f"descriptor_loop: n={n} outside [0, {F}]")
    out = torch.zeros((F, 128), dtype=torch.float32, device=blur.device)
    if n == 0:
        return out
    lib = build.load_library()
    build.launch(
        NAME, blur, lib.ps_descriptor_loop,
        blur.data_ptr(), L, H, W, x.data_ptr(), y.data_ptr(),
        sigma.data_ptr(), level.data_ptr(), ang.data_ptr(),
        valid.data_ptr(), n, radius, out.data_ptr())
    launches += 1
    return out


def descriptor_loop_patches_torch(patches, y0, x0, x, y, sigma, ang, valid,
                                  H: int, W: int,
                                  chunk: int = 64) -> torch.Tensor:
    """Plain version of the patch entry: the per-pixel math of
    popsift_tpu/ops/pallas/desc.py::_desc_math (:75-165) on every cell of
    every patch, gradients with zeros beyond the patch edge (:92-97),
    chunked over jobs."""
    F, P, PL = patches.shape
    dev = patches.device
    out = torch.zeros((F, 128), dtype=torch.float32, device=dev)
    ii = torch.arange(P, device=dev)
    jj = torch.arange(PL, device=dev)
    for s in range(0, F, chunk):
        e = min(F, s + chunk)
        p = patches[s:e]
        zc = torch.zeros_like(p[:, :, :1])
        zr = torch.zeros_like(p[:, :1, :])
        dxv = torch.cat([p[:, :, 1:], zc], 2) \
            - torch.cat([zc, p[:, :, :-1]], 2)
        dyv = torch.cat([p[:, 1:, :], zr], 1) \
            - torch.cat([zr, p[:, :-1, :]], 1)
        px = x0[s:e].long()[:, None, None] + jj[None, None, :]
        py = y0[s:e].long()[:, None, None] + ii[None, :, None]
        out[s:e] = _loop_terms(dxv, dyv, px, py, x[s:e], y[s:e], sigma[s:e],
                               ang[s:e], valid[s:e], H, W)
    return out


def descriptor_loop_patches(patches, y0, x0, x, y, sigma, ang, valid,
                            H: int, W: int) -> torch.Tensor:
    """f32[F, 128] raw descriptors of F jobs from their pre-cut windows
    ``patches`` f32[F, P, PL], cell (i, j) of job k being pixel
    (y0[k] + i, x0[k] + j) of an H x W octave level: plain version on the
    CPU, the patch entry of kernel K4 on a CUDA device."""
    global launches_patches
    if patches.dim() != 3 or patches.dtype != torch.float32:
        raise ValueError("descriptor_loop_patches expects f32[F, P, PL]")
    if patches.device.type == "cpu":
        return descriptor_loop_patches_torch(patches, y0, x0, x, y, sigma,
                                             ang, valid, H, W)
    patches = patches.contiguous()
    x, y, sigma, ang = (t.to(torch.float32).contiguous()
                        for t in (x, y, sigma, ang))
    y0, x0 = (t.to(torch.int32).contiguous() for t in (y0, x0))
    valid = valid.to(torch.uint8).contiguous()
    build.require_cuda(NAME_PATCHES, patches, y0, x0, x, y, sigma, ang, valid)
    F, P, PL = patches.shape
    out = torch.zeros((F, 128), dtype=torch.float32, device=patches.device)
    if F == 0:
        return out
    lib = build.load_library()
    build.launch(
        NAME_PATCHES, patches, lib.ps_descriptor_loop_patches,
        patches.data_ptr(), P, PL, H, W, y0.data_ptr(), x0.data_ptr(),
        x.data_ptr(), y.data_ptr(), sigma.data_ptr(), ang.data_ptr(),
        valid.data_ptr(), F, out.data_ptr())
    launches_patches += 1
    return out


def descriptor_loop_multibucket(blur, x, y, sigma, level, ang, valid,
                                buckets, plain: bool = False) -> torch.Tensor:
    """Sigma-bucketed form of :func:`descriptor_loop`
    (popsift_tpu/ops/pallas/desc.py:383-436). ``buckets`` is an ascending
    list of ``(sigma_hi, radius)`` pairs, the last ``sigma_hi`` ignored
    (it takes the rest): a valid job goes to the first bucket whose
    ``sigma_hi`` bounds its sigma, every bucket's jobs are packed to the
    front in row order (nonzero) and run through one K4 launch with that
    bucket's window radius, and the rows are scattered back. Invalid
    rows are zero. ``plain`` runs K4's plain version per bucket."""
    global launches_bucketed
    F = x.shape[0]
    out = torch.zeros((F, 128), dtype=torch.float32, device=blur.device)
    valid = valid.bool()
    remaining = valid
    before = launches
    fn = descriptor_loop_torch if plain else descriptor_loop
    for i, (s_hi, radius) in enumerate(buckets):
        m = remaining if i == len(buckets) - 1 \
            else remaining & (sigma <= s_hi)
        remaining = remaining & ~m
        rows = m.nonzero().squeeze(1)
        n = rows.numel()
        if n:
            out[rows] = fn(blur, x[rows], y[rows], sigma[rows], level[rows],
                           ang[rows], valid[rows], n, radius)
    launches_bucketed += 1 if launches > before else 0
    return out


def descriptor_loop_bucketed(blur, x, y, sigma, level, ang, valid,
                             radius: int, sigma_split: float,
                             radius_small: int,
                             plain: bool = False) -> torch.Tensor:
    """Two-bucket form of :func:`descriptor_loop_multibucket`
    (popsift_tpu/ops/pallas/desc.py:439-446)."""
    return descriptor_loop_multibucket(
        blur, x, y, sigma, level, ang, valid,
        [(sigma_split, radius_small), (None, radius)], plain)
