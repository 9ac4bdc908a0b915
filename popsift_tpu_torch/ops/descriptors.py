"""SIFT descriptors (loop variant) in PyTorch.

Port of :mod:`popsift_tpu.ops.descriptors` for ``desc_mode="loop"``: one
batched job build over all octaves (the flat (keypoint, orientation)
list, s_orientation.cu:274-299) with no count read back, the raw
descriptors of all octaves in one launch of kernel K4
(ops/kernels/desc.py), and RootSift or classic L2 normalisation. The
other descriptor variants raise NotImplementedError (ROADMAP A9).
"""

from __future__ import annotations

import math
from functools import lru_cache
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
    segment and ``counts`` i64[S] holds each segment's valid jobs.

    One pass over all segments, nothing read back: an entry's rank in its
    segment is one cumsum less the segment's start, and the entries of
    rank below ``jcap`` are scattered to their job rows (the others to a
    spare row that is dropped)."""
    O = ORIENTATION_MAX_COUNT
    c = _segment_layout(tuple(segments), None if level_offsets is None
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
