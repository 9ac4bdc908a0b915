"""SIFT descriptors in PyTorch, every variant of the config.

Port of :mod:`popsift_tpu.ops.descriptors`: one batched job build over
all octaves (the flat (keypoint, orientation) list,
s_orientation.cu:274-299) with no count read back, the raw descriptors
of all octaves, and RootSift or classic L2 normalisation.
``desc_mode="loop"`` runs all octaves in one launch of kernel K4
(ops/kernels/desc.py). The other variants are plain torch, as the JAX
package computes them in XLA (no Pallas kernel): ``igrid`` / ``notile``
(one implementation, a fixed 40 x 40 rotated grid of bilinear samples),
``grid`` (a 16 x 16 grid per tile at rounded pixel addresses) and
``iloop`` (a 32 x 32 axis-aligned grid per tile over the rotated tile's
bounding box). They run over the job rows of every octave in static
chunks, each row reading its own octave's blur stack, and the rows that
are not valid come out zero; no count is read back.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import DESC_BINS, DESC_MAGNIFY, ORIENTATION_MAX_COUNT, SiftConfig
from ..utils.f32 import div, full_f32
from .kernels.desc import (descriptor_loop, descriptor_loop_octaves,
                           descriptor_loop_octaves_torch,
                           descriptor_loop_torch)


class DescriptorJobs(NamedTuple):
    x: torch.Tensor        # f32[F]
    y: torch.Tensor
    sigma: torch.Tensor
    level: torch.Tensor    # i64[F]
    ang: torch.Tensor      # f32[F]
    kp_index: torch.Tensor  # i64[F] index into the segment's keypoints
    valid: torch.Tensor    # bool[F]
    count: torch.Tensor    # i64[]


@lru_cache(maxsize=32)
def _segment_layout(segments: tuple, level_offsets, device: torch.device):
    """Index constants of a segmented job build, made once per
    (segments, level offsets, device): per (keypoint, slot) entry of the
    segments its flat position, segment and position within the segment;
    per job row its segment, position within the segment and level
    offset; per segment its first keypoint row, first entry, first job
    row and job capacity."""
    O = ORIENTATION_MAX_COUNT
    starts = np.asarray([s for s, _, _ in segments], np.int64)
    sizes = np.asarray([K * O for _, K, _ in segments], np.int64)
    jcaps = np.asarray([j for _, _, j in segments], np.int64)
    ent_seg = np.repeat(np.arange(len(segments)), sizes)
    ent_first = np.concatenate([[0], np.cumsum(sizes)])
    ent_local = np.arange(int(sizes.sum())) - ent_first[ent_seg]
    ent_pos = starts[ent_seg] * O + ent_local
    job_seg = np.repeat(np.arange(len(segments)), jcaps)
    job_first = np.concatenate([[0], np.cumsum(jcaps)])
    job_local = np.arange(int(jcaps.sum())) - job_first[job_seg]
    lev = np.zeros(len(segments), np.int64) if level_offsets is None \
        else np.asarray(level_offsets, np.int64)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    # segments that tile the keypoint rows in order read them as they lie
    tiled = bool(np.array_equal(ent_pos, np.arange(ent_pos.size)))
    return dict(tiled=tiled, ent_pos=t(ent_pos), ent_seg=t(ent_seg),
                ent_local=t(ent_local), ent_first=t(ent_first),
                job_seg=t(job_seg), job_local=t(job_local),
                job_first=t(job_first[:-1]), jcap=t(jcaps),
                start=t(starts), job_level=t(lev[job_seg]),
                n_jobs=int(jcaps.sum()))


def make_descriptor_jobs_segmented(ext_x, ext_y, ext_sigma, ext_level,
                                   ori, ori_valid, segments,
                                   level_offsets=None, layout=None):
    """Front-packed job lists of many segments of the concatenated
    keypoint arrays, port of popsift_tpu.ops.descriptors
    .make_descriptor_jobs_segmented (:70-130).

    ``segments``: ``((start, K, jcap), ...)``: rows [start, start+K)
    become ``jcap`` job rows, the set (keypoint, slot) pairs in ascending
    flat order first; padding rows point at (row 0, slot 0) of the
    segment, as in JAX. ``level_offsets`` optionally adds a per-segment
    offset to the gathered level (the batched path's ``frame * L`` layer
    addressing). ``layout`` is the segments' index tensors made
    beforehand (``_segment_layout``), for a caller that keeps them, as a
    CUDA graph that reads them must. Returns ``(jobs, counts)``;
    ``kp_index`` is local to its segment and ``counts`` i64[S] holds each
    segment's valid jobs.

    One pass over all segments, nothing read back: an entry's rank in its
    segment is one cumsum less the segment's start, and the entries of
    rank below ``jcap`` are scattered to their job rows (the others to a
    spare row that is dropped)."""
    O = ORIENTATION_MAX_COUNT
    c = layout if layout is not None else _segment_layout(
        tuple(segments), None if level_offsets is None
        else tuple(level_offsets), ext_x.device)
    v = ori_valid.reshape(-1)
    if not c["tiled"] or v.numel() != c["ent_pos"].numel():
        v = v[c["ent_pos"]]
    v = v.long()
    before = torch.cumsum(v, 0) - v                 # set entries before
    edge = torch.cat([before, (before[-1:] + v[-1:])])
    base = edge[c["ent_first"]]                     # per segment, and end
    counts = torch.minimum(base[1:] - base[:-1], c["jcap"])
    rank = before - base[:-1][c["ent_seg"]]
    keep = (v > 0) & (rank < c["jcap"][c["ent_seg"]])
    n_jobs = c["n_jobs"]
    dest = torch.where(keep, c["job_first"][c["ent_seg"]] + rank, n_jobs)
    idx = torch.zeros(n_jobs + 1, dtype=torch.long, device=ext_x.device)
    idx = idx.scatter(0, dest, c["ent_local"])[:n_jobs]
    kpl = idx // O
    kpg = kpl + c["start"][c["job_seg"]]
    level = ext_level[kpg]
    if level_offsets is not None:
        level = level + c["job_level"]
    valid = c["job_local"] < counts[c["job_seg"]]
    jobs = DescriptorJobs(
        x=ext_x[kpg], y=ext_y[kpg], sigma=ext_sigma[kpg],
        level=level, ang=ori[kpg, idx % O], kp_index=kpl,
        valid=valid, count=counts.sum())
    return jobs, counts


def make_descriptor_jobs(ext, oris, capacity: int) -> DescriptorJobs:
    """The padded job list of one octave's (extremum, orientation) pairs,
    port of popsift_tpu.ops.descriptors.make_descriptor_jobs (:54-67):
    the one-segment form of :func:`make_descriptor_jobs_segmented`, the
    set pairs in ascending flat order first, padding rows at (row 0,
    slot 0), ``count`` the valid jobs (at most ``capacity``)."""
    jobs, _ = make_descriptor_jobs_segmented(
        ext.x, ext.y, ext.sigma, ext.level, oris.ori, oris.ori_valid,
        ((0, ext.x.shape[0], capacity),))
    return jobs


def loop_patch_radius(cfg: SiftConfig) -> int:
    """Static window bound of the loop variant: |p - kp|_inf <
    2.5 sqrt(2) SBP, sigma at sn < maxlevel - 0.5 (s_desc_loop.cu:58-91)."""
    sigma_max = cfg.sigma * 2.0 ** ((cfg.total_levels - 1.5) / cfg.levels)
    sbp_max = DESC_MAGNIFY * sigma_max
    return int(math.ceil(2.5 * math.sqrt(2.0) * sbp_max)) + 2


# --- the variants computed in plain torch (XLA in the JAX package) --------

def _grid_tables():
    """The igrid sample offsets (SBP units), Gaussian envelope and
    sample -> tile weights (sift_constants.cu:34-47), as the JAX
    package's numpy tables."""
    step = 1.0 / 8.0
    base = 0.5 * step - 20.0 * step          # -2.4375
    pos = base + np.arange(40) * step        # 40 sample offsets in SBP units
    gx, gy = np.meshgrid(pos, pos)
    ww = np.exp(-0.125 * (gx * gx + gy * gy)).astype(np.float32)
    tile = 1.0 - np.abs(-1.0 + 1.0 / 16.0 + np.arange(16) / 8.0)
    Wt = np.zeros((40, 4), np.float32)       # sample -> tile weight matrix
    for t in range(4):
        for k in range(16):
            Wt[t * 8 + k, t] = tile[k]
    return pos.astype(np.float32), ww, Wt


_GRID_POS, _GRID_WW, _GRID_WT = _grid_tables()
_TWO_PI = np.float32(2.0 * math.pi)
_FOUR_OVER_PI = np.float32(4.0 / math.pi)
# samples a row computes, per variant: the chunk holds about
# _CHUNK_SAMPLES[device type] of them (a CUDA device takes wider chunks)
_ROW_SAMPLES = {"igrid": 40 * 40 * DESC_BINS, "notile": 40 * 40 * DESC_BINS,
                "grid": 16 * 16 * 16, "iloop": 16 * 32 * 32}
_CHUNK_SAMPLES = {"cpu": 1 << 22, "cuda": 1 << 24}


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The grid tables and the tile / sample offsets on ``device``, never
    dropped: a captured CUDA graph reads them by address."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return dict(pos=t(_GRID_POS), ww=t(_GRID_WW), Wt=t(_GRID_WT),
                tile_off=t(np.arange(4) - 1.5),
                half16=t((np.arange(16) + 0.5) / 8.0),
                idx32=t(np.arange(32)),
                bins=torch.arange(DESC_BINS, device=device))


def _bilinear(blur: torch.Tensor, lvl: torch.Tensor, xs: torch.Tensor,
              ys: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sample of the layered image ``blur`` [L, H, W]
    (linear-texture readTex semantics, popsift_tpu.ops.descriptors
    ._bilinear); ``lvl`` broadcasts against ``xs``/``ys``."""
    L, H, W = blur.shape
    xs = xs.clamp(0.0, W - 1.0)
    ys = ys.clamp(0.0, H - 1.0)
    x0 = torch.floor(xs).long()
    y0 = torch.floor(ys).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    fx = xs - x0.to(torch.float32)
    fy = ys - y0.to(torch.float32)
    base = lvl.clamp(0, L - 1) * (H * W)
    flat = blur.reshape(-1)
    r0, r1 = base + y0 * W, base + y1 * W
    v00, v01 = flat[r0 + x0], flat[r0 + x1]
    v10, v11 = flat[r1 + x0], flat[r1 + x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _wrap_2pi(th: torch.Tensor) -> torch.Tensor:
    th = torch.where(th < 0.0, th + _TWO_PI, th)
    return torch.where(th >= _TWO_PI, th - _TWO_PI, th)


def _bin_weights(th: torch.Tensor):
    """(lower bin, upper bin, fraction) of angles in [0, 2 pi) over the
    8 orientation bins."""
    tth = th * _FOUR_OVER_PI
    fo = torch.floor(tth).long()
    frac = tth - fo.to(torch.float32)
    return fo % DESC_BINS, (fo + 1) % DESC_BINS, frac


def _per_bin_sums(wgt, fo0, fo1, frac) -> torch.Tensor:
    """[F, 4, 4, 8]: per bin, the weights over the last two (sample)
    axes, with each sample's weight split between its two bins."""
    cols = []
    for b in range(DESC_BINS):
        cb = wgt * (torch.where(fo0 == b, 1.0 - frac, 0.0)
                    + torch.where(fo1 == b, frac, 0.0))
        cols.append(cb.sum(dim=(-2, -1)))
    return torch.stack(cols, dim=-1)


def _zero_rows(desc: torch.Tensor, sbp: torch.Tensor, valid: torch.Tensor
               ) -> torch.Tensor:
    zero = (sbp == 0.0) | ~valid
    return torch.where(zero[:, None], torch.zeros_like(desc), desc)


def _descriptor_grid_chunk(blur: torch.Tensor, jobs: DescriptorJobs
                           ) -> torch.Tensor:
    """``igrid`` / ``notile``: a fixed 40 x 40 rotated grid per job,
    gradients by rotated central differences through bilinear samples,
    the histogram as two products with the tile weight matrix
    (popsift_tpu.ops.descriptors._descriptor_grid_chunk)."""
    F = jobs.x.shape[0]
    t = _tables(jobs.x.device)
    sbp = (np.float32(DESC_MAGNIFY) * jobs.sigma).abs()[:, None, None]
    cos_t = torch.cos(jobs.ang)[:, None, None]
    sin_t = torch.sin(jobs.ang)[:, None, None]
    sx = t["pos"][None, None, :]
    sy = t["pos"][None, :, None]
    px = jobs.x[:, None, None] + (cos_t * sx - sin_t * sy) * sbp
    py = jobs.y[:, None, None] + (cos_t * sy + sin_t * sx) * sbp
    lvl = jobs.level[:, None, None]
    dx = (_bilinear(blur, lvl, px + cos_t, py + sin_t)
          - _bilinear(blur, lvl, px - cos_t, py - sin_t))
    dy = (_bilinear(blur, lvl, px - sin_t, py + cos_t)
          - _bilinear(blur, lvl, px + sin_t, py - cos_t))
    mod = torch.sqrt(dx * dx + dy * dy)
    fo0, fo1, frac = _bin_weights(_wrap_2pi(torch.atan2(dy, dx)))
    wgt = t["ww"][None] * mod                          # [F, 40, 40]
    bins = t["bins"]
    contrib = ((wgt * (1.0 - frac))[..., None]
               * (fo0[..., None] == bins).to(torch.float32)
               + (wgt * frac)[..., None]
               * (fo1[..., None] == bins).to(torch.float32))
    with full_f32():
        t1 = torch.einsum("fyxb,yi->fixb", contrib, t["Wt"])
        desc = torch.einsum("fixb,xj->fijb", t1, t["Wt"])   # [F, iy, ix, b]
    return _zero_rows(desc.reshape(F, 128), sbp[:, 0, 0], jobs.valid)


def _descriptor_tilegrid_chunk(blur: torch.Tensor, jobs: DescriptorJobs
                               ) -> torch.Tensor:
    """``grid``: per 4 x 4 tile a 16 x 16 rotated grid whose addresses
    are rounded to whole pixels (half away from zero, as CUDA
    ``round``), axis-aligned central differences there, tile and
    envelope weights from the rounded position; a sample feeds only its
    own tile (popsift_tpu.ops.descriptors._descriptor_tilegrid_chunk)."""
    F = jobs.x.shape[0]
    t = _tables(jobs.x.device)
    sbp = (np.float32(DESC_MAGNIFY) * jobs.sigma).abs()     # [F]
    c = torch.cos(jobs.ang)
    s = torch.sin(jobs.ang)
    ox = t["tile_off"][None, None, :]                        # [1, 1, 4]
    oy = t["tile_off"][None, :, None]                        # [1, 4, 1]
    cB, sB, sbpB = c[:, None, None], s[:, None, None], sbp[:, None, None]
    ptx = jobs.x[:, None, None] + (cB * ox - sB * oy) * sbpB  # [F, 4, 4]
    pty = jobs.y[:, None, None] + (cB * oy + sB * ox) * sbpB
    xd = t["half16"][None, :]                                # [1, 16]
    yd = t["half16"][:, None]                                # [16, 1]
    c5 = c[:, None, None, None, None]
    s5 = s[:, None, None, None, None]
    pixo_x = (-c5 + s5) + c5 * xd - s5 * yd                  # [F,1,1,16,16]
    pixo_y = (-c5 - s5) + s5 * xd + c5 * yd
    sbp5 = sbp[:, None, None, None, None]
    absx = ptx[..., None, None] + pixo_x * sbp5              # [F,4,4,16,16]
    absy = pty[..., None, None] + pixo_y * sbp5
    rx = torch.sign(absx) * torch.floor(absx.abs() + 0.5)
    ry = torch.sign(absy) * torch.floor(absy.abs() + 0.5)
    lvl = jobs.level[:, None, None, None, None]
    dx = (_bilinear(blur, lvl, rx + 1.0, ry)
          - _bilinear(blur, lvl, rx - 1.0, ry))
    dy = (_bilinear(blur, lvl, rx, ry + 1.0)
          - _bilinear(blur, lvl, rx, ry - 1.0))
    mod = torch.sqrt(dx * dx + dy * dy)
    th = torch.atan2(dy, dx)
    pos = sbp5 > 0
    ones = torch.ones_like(sbp5)
    inv_sbp = torch.where(pos, ones / torch.where(pos, sbp5, ones),
                          torch.zeros_like(sbp5))
    pxo = (rx - ptx[..., None, None]) * inv_sbp
    pyo = (ry - pty[..., None, None]) * inv_sbp
    nx = c5 * pxo + s5 * pyo                                 # inverse rot
    ny = c5 * pyo - s5 * pxo
    dnx = nx + ox[..., None, None]
    dny = ny + oy[..., None, None]
    ww = torch.exp(np.float32(-0.125) * (dnx * dnx + dny * dny))
    wx = 1.0 - nx.abs()
    wy = 1.0 - ny.abs()
    keep = (wx >= 0.0) & (wy >= 0.0)
    wgt = torch.where(keep, ww * wx * wy * mod, torch.zeros_like(mod))
    fo0, fo1, frac = _bin_weights(
        _wrap_2pi(th - jobs.ang[:, None, None, None, None]))
    desc = _per_bin_sums(wgt, fo0, fo1, frac).reshape(F, 128)
    return _zero_rows(desc, sbp, jobs.valid)


def _descriptor_iloop_chunk(blur: torch.Tensor, jobs: DescriptorJobs
                            ) -> torch.Tensor:
    """``iloop``: per tile a 32 x 32 axis-aligned grid over the rotated
    tile's bounding box (half-width |cos| + |sin| in SBP units), samples
    outside the tile skipped, gradients by rotated central differences
    through bilinear samples, so no ``th -= ang``
    (popsift_tpu.ops.descriptors._descriptor_iloop_chunk)."""
    F = jobs.x.shape[0]
    t = _tables(jobs.x.device)
    sbp = (np.float32(DESC_MAGNIFY) * jobs.sigma).abs()
    c = torch.cos(jobs.ang)
    s = torch.sin(jobs.ang)
    bsz = c.abs() + s.abs()                                  # [F]
    ox = t["tile_off"][None, None, :]
    oy = t["tile_off"][None, :, None]
    cB, sB, sbpB = c[:, None, None], s[:, None, None], sbp[:, None, None]
    ptx = (cB * ox - sB * oy) * sbpB                         # [F, 4, 4]
    pty = (cB * oy + sB * ox) * sbpB
    idx = t["idx32"]
    c5 = c[:, None, None, None, None]
    s5 = s[:, None, None, None, None]
    b5 = bsz[:, None, None, None, None]
    dx = -b5 + div(idx[None, None, None, None, :] * b5, 16.0)  # [F,1,1,1,32]
    dy = -b5 + div(idx[None, None, None, :, None] * b5, 16.0)  # [F,1,1,32,1]
    nx = c5 * dx + s5 * dy                                   # [F,1,1,32,32]
    ny = c5 * dy - s5 * dx
    keep = (nx.abs() < 1.0) & (ny.abs() < 1.0)
    sbp5 = sbp[:, None, None, None, None]
    px = (jobs.x[:, None, None, None, None] + ptx[..., None, None]
          + dx * sbp5)
    py = (jobs.y[:, None, None, None, None] + pty[..., None, None]
          + dy * sbp5)
    lvl = jobs.level[:, None, None, None, None]
    gdx = (_bilinear(blur, lvl, px + c5, py + s5)
           - _bilinear(blur, lvl, px - c5, py - s5))
    gdy = (_bilinear(blur, lvl, px - s5, py + c5)
           - _bilinear(blur, lvl, px + s5, py - c5))
    mod = torch.sqrt(gdx * gdx + gdy * gdy)
    fo0, fo1, frac = _bin_weights(_wrap_2pi(torch.atan2(gdy, gdx)))
    dnx = nx + ox[..., None, None]
    dny = ny + oy[..., None, None]
    ww = torch.exp(np.float32(-0.125) * (dnx * dnx + dny * dny))
    wgt = torch.where(keep, ww * (1.0 - nx.abs()) * (1.0 - ny.abs()) * mod,
                      torch.zeros_like(mod))
    desc = _per_bin_sums(wgt, fo0, fo1, frac).reshape(F, 128)
    return _zero_rows(desc, sbp, jobs.valid)


_VARIANTS = {"igrid": _descriptor_grid_chunk,
             "notile": _descriptor_grid_chunk,
             "grid": _descriptor_tilegrid_chunk,
             "iloop": _descriptor_iloop_chunk}


def variant_chunk_rows(mode: str, device: torch.device) -> int:
    """Job rows a chunk of the plain-torch variant ``mode`` takes on
    ``device``: static, so that no count decides a shape."""
    budget = _CHUNK_SAMPLES.get(device.type, _CHUNK_SAMPLES["cpu"])
    return max(1, budget // _ROW_SAMPLES[mode])


def _jobs_rows(jobs: DescriptorJobs, lo: int, hi: int) -> DescriptorJobs:
    return DescriptorJobs(*(f[lo:hi] for f in jobs[:-1]), count=jobs.count)


def descriptor_variant(blurs, jobs: DescriptorJobs, row_ends,
                       cfg: SiftConfig) -> torch.Tensor:
    """Unnormalized f32[F, 128] descriptors of the ``grid``, ``igrid``,
    ``notile`` or ``iloop`` variant over the job rows of all octaves
    (octave o owns rows [row_ends[o-1], row_ends[o]) and reads
    ``blurs[o]``), in static chunks of rows."""
    fn = _VARIANTS[cfg.desc_mode]
    chunk = variant_chunk_rows(cfg.desc_mode, jobs.x.device)
    out, start = [], 0
    for blur, end in zip(blurs, row_ends):
        for lo in range(start, int(end), chunk):
            out.append(fn(blur, _jobs_rows(jobs, lo, min(lo + chunk,
                                                         int(end)))))
        start = int(end)
    return torch.cat(out) if out else jobs.x.new_zeros((0, 128))


def compute_descriptors(blur: torch.Tensor, jobs: DescriptorJobs,
                        cfg: SiftConfig, plain: bool = False) -> torch.Tensor:
    """Unnormalized f32[F, 128] descriptors of one octave's job list
    (front-packed: jobs [0, count) are the valid ones): ``loop`` by
    kernel K4 or, with ``plain``, its plain version; the other variants
    in plain torch."""
    if cfg.desc_mode != "loop":
        return descriptor_variant([blur], jobs, [jobs.x.shape[0]], cfg)
    fn = descriptor_loop_torch if plain else descriptor_loop
    return fn(blur, jobs.x, jobs.y, jobs.sigma, jobs.level,
              jobs.ang, jobs.valid, int(jobs.count), loop_patch_radius(cfg))


def compute_descriptors_octaves(blurs, jobs: DescriptorJobs, row_ends,
                                cfg: SiftConfig, plain: bool = False,
                                y_offsets=None,
                                y_bounds=None) -> torch.Tensor:
    """Unnormalized f32[F, 128] descriptors of the job rows of all
    octaves (octave o owns rows [row_ends[o-1], row_ends[o]) of ``jobs``
    and reads ``blurs[o]``): ``loop`` in one launch of kernel K4 or, with
    ``plain``, by its plain version; the other variants in plain torch
    (:func:`descriptor_variant`). Only ``jobs.valid`` decides which rows
    count; no count is read back. A row band passes its octaves' global
    row offsets and scan rows (``y_offsets``, ``y_bounds``: K4's row
    bounds). As in JAX (descriptors.py:555-562) only ``loop`` honours
    them; the other variants read each stack as it lies, so a caller
    gives them the jobs in the stacks' own rows."""
    if cfg.desc_mode != "loop":
        return descriptor_variant(blurs, jobs, row_ends, cfg)
    fn = descriptor_loop_octaves_torch if plain else descriptor_loop_octaves
    return fn(list(blurs), [int(e) for e in row_ends], jobs.x, jobs.y,
              jobs.sigma, jobs.level, jobs.ang, jobs.valid,
              loop_patch_radius(cfg), y_offsets=y_offsets,
              y_bounds=y_bounds)


def normalize_descriptors(desc: torch.Tensor, cfg: SiftConfig
                          ) -> torch.Tensor:
    """RootSift (s_desc_norm_rs.h:44-80) or classic L2 with the 0.2 clamp
    (s_desc_norm_l2.h:85-131); both scaled by 2^norm_multiplier."""
    mult = 2.0 ** cfg.norm_multiplier
    if cfg.norm_mode == "rootsift":
        s = desc.sum(-1, keepdim=True)
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        return torch.sqrt(desc.clamp(min=0.0) / s) * mult
    n = torch.sqrt((desc * desc).sum(-1, keepdim=True))
    clamped = torch.minimum(desc, 0.2 * n)
    n2 = (clamped * clamped).sum(-1, keepdim=True)
    n2 = torch.where(n2 == 0.0, torch.ones_like(n2), n2)
    return clamped * torch.rsqrt(n2) * mult
