"""End-to-end SIFT extraction in PyTorch.

Port of :mod:`popsift_tpu.pipeline` -- the dense-stack (non-canvas)
branch of ``extract`` (pipeline.py:237-406): the pyramid as dense
per-octave stacks, per octave the candidate mask (K1) and compaction and
the refinement (K2), ONE batched accept test over all octaves, per
octave the orientation histograms (K3), one orientation tail, one
segmented job build, per octave the descriptors (K4), then normalisation
and the output tail (octave scaling, descriptor -> keypoint map).

Counts that size a kernel launch (candidates, jobs per octave) are read
back to the host between stages; everything else stays on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .config import SiftConfig
from .ops import descriptors as _desc
from .ops import extrema as _ext
from .ops import orientation as _ori
from .ops.pyramid import PyramidPlan, build_pyramid, build_pyramid_plan
from .utils.device import resolve_device


class SiftFeatures(NamedTuple):
    """Capacity-padded extraction result (tensors on the run's device)."""

    x: torch.Tensor            # keypoints [K_total], input-image coords
    y: torch.Tensor
    sigma: torch.Tensor
    octave: torch.Tensor
    num_ori: torch.Tensor
    valid: torch.Tensor
    ori: torch.Tensor          # [K_total, 4]
    ori_valid: torch.Tensor    # [K_total, 4]
    desc: torch.Tensor         # [F_total, 128]
    desc_kp: torch.Tensor      # [F_total] -> keypoint row (reverse map)
    desc_valid: torch.Tensor   # [F_total]
    n_keypoints: torch.Tensor
    n_descriptors: torch.Tensor
    octave_candidates: torch.Tensor   # i64[n_octaves], saturates at cap
    octave_dropped: torch.Tensor      # i64[n_octaves], density clamp


@dataclass(frozen=True)
class ExtractPlan:
    """Static plan: shapes, capacities and filters for one (config, size)."""

    config: SiftConfig
    height: int
    width: int
    pyramid: PyramidPlan
    ext_caps: tuple      # per-octave extrema capacity
    job_caps: tuple      # per-octave descriptor-job capacity


def build_extract_plan(config: SiftConfig, height: int, width: int,
                       octave_caps: tuple | None = None) -> ExtractPlan:
    """The static plan; ``octave_caps`` optionally pins per-octave
    extrema capacities (the last entry repeats). Job capacity is 1.25x
    (sift_constants.cu:31)."""
    pyr = build_pyramid_plan(config, height, width)
    ext_caps, job_caps = [], []
    for octv, (oh, ow) in enumerate(pyr.dims):
        if octave_caps is not None:
            cap = octave_caps[min(octv, len(octave_caps) - 1)]
        else:
            cap = config.capacity_for_octave(oh, ow)
        cap = min(cap, config.max_extrema)
        ext_caps.append(cap)
        job_caps.append(cap + cap // 4)
    return ExtractPlan(config=config, height=height, width=width,
                       pyramid=pyr, ext_caps=tuple(ext_caps),
                       job_caps=tuple(job_caps))


def extract(img, plan: ExtractPlan, device, *,
            plain: bool = False) -> SiftFeatures:
    """Run the full pipeline on one [H, W] uint8 (or [0, 1] float32)
    image, given as a numpy array or tensor, on ``device``.

    On a CUDA device every kernel stage runs its CUDA kernel. ``plain``
    runs every stage's plain PyTorch version instead, on the same device:
    the baseline the kernels are timed against. It is never chosen on
    its own."""
    cfg = plan.config
    if cfg.filter_max_extrema > 0:
        raise NotImplementedError("grid filter (ROADMAP A4)")
    if cfg.desc_mode != "loop":
        raise NotImplementedError(f"desc_mode {cfg.desc_mode!r} (ROADMAP A9)")
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img)).to(dev)
    if tuple(img.shape) != (plan.height, plan.width):
        raise ValueError(f"image {tuple(img.shape)} does not match the plan "
                         f"({plan.height}, {plan.width})")
    caps = plan.ext_caps
    dims = plan.pyramid.dims
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)

    blurs, dogs = build_pyramid(img, plan.pyramid)

    # detection: mask + compaction + refinement per octave, one batched
    # accept test over all octaves (each row carries its octave's dims)
    cands = [_ext.collect_candidates(dog, cfg, caps[o], plain)
             for o, dog in enumerate(dogs)]
    n_found = [int(c.n_found) for c in cands]
    state = torch.cat([_ext.refine_candidates(dogs[o], c, cfg, plain)
                       for o, c in enumerate(cands)])
    octv_row = np.concatenate(
        [np.full(caps[o], o, np.int64) for o in range(len(caps))])
    w_row = torch.as_tensor(np.concatenate(
        [np.full(caps[o], ow, np.int64) for o, (_, ow) in enumerate(dims)]),
        device=dev)
    h_row = torch.as_tensor(np.concatenate(
        [np.full(caps[o], oh, np.int64) for o, (oh, _) in enumerate(dims)]),
        device=dev)
    g = _ext.finalize_refined(
        state, torch.cat([c.valid for c in cands]), cfg, w_row, h_row,
        sum(n_found), torch.stack([c.n_dropped for c in cands]).sum())

    # orientation: per-octave histograms, one batched peak tail
    def oct_slice(a, o):
        return a[offs[o]:offs[o + 1]]

    hists = []
    for o in range(len(caps)):
        ext_o = g._replace(
            x=oct_slice(g.x, o), y=oct_slice(g.y, o), s=oct_slice(g.s, o),
            level=oct_slice(g.level, o), sigma=oct_slice(g.sigma, o),
            cell=oct_slice(g.cell, o), valid=oct_slice(g.valid, o))
        hists.append(_ori.orientation_histograms(blurs[o], ext_o, cfg,
                                                 n_found[o], plain))
    oris = _ori.orientations_from_histograms(torch.cat(hists), g.valid,
                                             smoothing=cfg.ori_smoothing)

    # descriptors: one segmented job build, per-octave kernels
    segs = tuple((int(offs[o]), caps[o], plan.job_caps[o])
                 for o in range(len(caps)))
    jobs_all, counts = _desc.make_descriptor_jobs_segmented(
        g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid, segs)
    jobs_off = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)
    counts_host = counts.tolist()
    raw, job_kps = [], []
    for o in range(len(caps)):
        jsl = slice(int(jobs_off[o]), int(jobs_off[o + 1]))
        jobs = _desc.DescriptorJobs(
            x=jobs_all.x[jsl], y=jobs_all.y[jsl], sigma=jobs_all.sigma[jsl],
            level=jobs_all.level[jsl], ang=jobs_all.ang[jsl],
            kp_index=jobs_all.kp_index[jsl], valid=jobs_all.valid[jsl],
            count=counts_host[o])
        raw.append(_desc.compute_descriptors(blurs[o], jobs, cfg, plain))
        job_kps.append(jobs.kp_index + int(offs[o]))

    desc_valid = jobs_all.valid
    desc = _desc.normalize_descriptors(torch.cat(raw), cfg)
    desc = torch.where(desc_valid[:, None], desc, torch.zeros_like(desc))

    scale_row = torch.as_tensor(
        np.exp2(octv_row.astype(np.float32)
                - np.float32(cfg.upscale_factor)).astype(np.float32),
        device=dev)
    return SiftFeatures(
        x=g.x * scale_row,
        y=g.y * scale_row,
        sigma=g.sigma * scale_row,
        octave=torch.as_tensor(octv_row, device=dev),
        num_ori=oris.num_ori,
        valid=g.valid,
        ori=oris.ori,
        ori_valid=oris.ori_valid,
        desc=desc,
        desc_kp=torch.cat(job_kps),
        desc_valid=desc_valid,
        n_keypoints=g.valid.sum(),
        n_descriptors=desc_valid.sum(),
        octave_candidates=torch.stack([c.n_found for c in cands]),
        octave_dropped=torch.stack([c.n_dropped for c in cands]),
    )


def saturation_report(feats: SiftFeatures, plan: ExtractPlan) -> list:
    """Warnings when an octave hit its candidate capacity or the
    compaction density clamp dropped candidates (the reference clamps
    silently, s_extrema.cu:551-561)."""
    warnings = []
    cand = feats.octave_candidates.cpu().numpy()
    dropped = feats.octave_dropped.cpu().numpy()
    for octv, cap in enumerate(plan.ext_caps):
        if cand[octv] >= cap:
            warnings.append(
                f"octave {octv}: candidate count saturated at capacity "
                f"{cap}; keypoints are being silently dropped -- raise "
                f"extrema_capacity")
        if dropped[octv] > 0:
            warnings.append(
                f"octave {octv}: {int(dropped[octv])} candidates dropped "
                f"by the per-block density clamp; raise "
                f"config.compact_block_k or the peak threshold")
    return warnings
