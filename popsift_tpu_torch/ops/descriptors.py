"""SIFT descriptors (loop variant) in PyTorch.

Port of :mod:`popsift_tpu.ops.descriptors` for ``desc_mode="loop"``: one
batched job build over all octaves (the flat (keypoint, orientation)
list, s_orientation.cu:274-299), the raw descriptors of all octaves in
one launch of kernel K4 (ops/kernels/desc.py), and RootSift or classic
L2 normalisation. The
other descriptor variants raise NotImplementedError (ROADMAP A9).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import DESC_MAGNIFY, ORIENTATION_MAX_COUNT, SiftConfig
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


def make_descriptor_jobs_segmented(ext_x, ext_y, ext_sigma, ext_level,
                                   ori, ori_valid, segments,
                                   level_offsets=None):
    """Front-packed job lists of many segments of the concatenated
    keypoint arrays, port of popsift_tpu.ops.descriptors
    .make_descriptor_jobs_segmented (:70-130).

    ``segments``: ``((start, K, jcap), ...)``: rows [start, start+K)
    become ``jcap`` job rows, the set (keypoint, slot) pairs in ascending
    flat order first; padding rows point at (row 0, slot 0) of the
    segment, as in JAX. ``level_offsets`` optionally adds a per-segment
    offset to the gathered level (the batched path's ``frame * L`` layer
    addressing). Returns ``(jobs, counts)``; ``kp_index`` is local to its
    segment and ``counts`` i64[S] holds each segment's valid jobs."""
    O = ORIENTATION_MAX_COUNT
    dev = ext_x.device
    kp_loc, kp_glob, slots, valids, counts, lev_off = [], [], [], [], [], []
    for i, (s, K, jcap) in enumerate(segments):
        flat = ori_valid[s:s + K].reshape(-1)
        nz = flat.nonzero().squeeze(1)[:jcap]
        idx = torch.zeros(jcap, dtype=torch.long, device=dev)
        idx[:nz.numel()] = nz
        kp = idx // O
        kp_loc.append(kp)
        kp_glob.append(kp + s)
        slots.append(idx % O)
        n = torch.clamp(flat.sum(), max=jcap)
        counts.append(n)
        valids.append(torch.arange(jcap, device=dev) < n)
        if level_offsets is not None:
            lev_off.append(np.full(jcap, level_offsets[i], np.int64))
    kpl = torch.cat(kp_loc)
    kpg = torch.cat(kp_glob)
    slot = torch.cat(slots)
    counts = torch.stack(counts)
    level = ext_level[kpg]
    if level_offsets is not None:
        level = level + torch.as_tensor(np.concatenate(lev_off), device=dev)
    jobs = DescriptorJobs(
        x=ext_x[kpg], y=ext_y[kpg], sigma=ext_sigma[kpg],
        level=level, ang=ori[kpg, slot], kp_index=kpl,
        valid=torch.cat(valids), count=counts.sum())
    return jobs, counts


def loop_patch_radius(cfg: SiftConfig) -> int:
    """Static window bound of the loop variant: |p - kp|_inf <
    2.5 sqrt(2) SBP, sigma at sn < maxlevel - 0.5 (s_desc_loop.cu:58-91)."""
    sigma_max = cfg.sigma * 2.0 ** ((cfg.total_levels - 1.5) / cfg.levels)
    sbp_max = DESC_MAGNIFY * sigma_max
    return int(math.ceil(2.5 * math.sqrt(2.0) * sbp_max)) + 2


def compute_descriptors(blur: torch.Tensor, jobs: DescriptorJobs,
                        cfg: SiftConfig, plain: bool = False) -> torch.Tensor:
    """Unnormalized f32[F, 128] descriptors of one octave's job list
    (front-packed: jobs [0, count) are the valid ones), by kernel K4 or,
    with ``plain``, its plain version."""
    if cfg.desc_mode != "loop":
        raise NotImplementedError(
            f"desc_mode {cfg.desc_mode!r} (ROADMAP A9); the port has loop")
    fn = descriptor_loop_torch if plain else descriptor_loop
    return fn(blur, jobs.x, jobs.y, jobs.sigma, jobs.level,
              jobs.ang, jobs.valid, int(jobs.count), loop_patch_radius(cfg))


def compute_descriptors_octaves(blurs, jobs: DescriptorJobs, row_ends,
                                cfg: SiftConfig,
                                plain: bool = False) -> torch.Tensor:
    """Unnormalized f32[F, 128] descriptors of the job rows of all
    octaves (octave o owns rows [row_ends[o-1], row_ends[o]) of ``jobs``
    and reads ``blurs[o]``), in one launch of kernel K4 or, with
    ``plain``, by its plain version. Only ``jobs.valid`` decides which
    rows run; no count is read back."""
    if cfg.desc_mode != "loop":
        raise NotImplementedError(
            f"desc_mode {cfg.desc_mode!r} (ROADMAP A9); the port has loop")
    fn = descriptor_loop_octaves_torch if plain else descriptor_loop_octaves
    return fn(list(blurs), [int(e) for e in row_ends], jobs.x, jobs.y,
              jobs.sigma, jobs.level, jobs.ang, jobs.valid,
              loop_patch_radius(cfg))


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
