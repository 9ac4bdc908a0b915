"""End-to-end SIFT extraction in PyTorch.

Port of :mod:`popsift_tpu.pipeline` -- the dense-stack (non-canvas)
branch of ``extract`` (pipeline.py:237-406): the pyramid as dense
per-octave stacks, the candidate masks of all octaves in one launch
(K1), per octave the compaction and the refinement (K2), ONE batched
accept test over all octaves, the orientation histograms of all octaves
in one launch (K3), one orientation tail, one segmented job build, the
descriptors of all octaves in one launch (K4),
then normalisation and the output tail (octave scaling, descriptor ->
keypoint map).

Counts that size a kernel launch (candidates per octave) are read back
to the host between stages; the descriptor kernel reads the jobs' valid
flags on the device. Everything else stays on the device.

:func:`extract_batch` is the frame-batched form (pipeline.py:409-753 on
dense stacks): F frames' pyramids share one K5 launch per level, each
octave's stacks hold the frames back to back on the layer axis
([F*L, H, W] and [F*(L-1), H, W]), K2 runs once per octave for all
frames, K1, K3 and K4 once for the whole batch, K3 and K4 addressing
frame f's level l as layer f*L + l. Every
output gains a leading [F] axis. ``extract_batch`` of one frame equals
``extract`` but runs more host glue (its per-frame compactions and
frame-major reshapes), so the single-frame path keeps its own stages
(PERF.md §6).
:func:`calibrate_plan` sizes per-octave capacities from a detect-only
probe (pipeline.py:787-831).

Two keywords choose between the JAX package's routes. ``detect="fused"``
(the default; JAX's ``POPSIFT_TPU_FUSED_REFINE=1``) refines with K2
straight from the DoG stack, once per octave. ``detect="windows"`` is
the JAX package's default route (pipeline.py:233-276): per octave the
collection also copies each candidate's DoG window (K6), then ONE
``refine_patches`` runs over the merged windows of all octaves.
``front="level"`` (the default) blurs with K5 once per level,
``front="chain"`` with K7 once per group of levels (JAX's
``use_pallas="chain"``). Both routes give the same features.
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
from .ops.pyramid import (PyramidPlan, build_pyramid, build_pyramid_frames,
                          build_pyramid_plan)
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


DETECT_ROUTES = ("fused", "windows")


def _check_supported(cfg: SiftConfig, detect: str = "fused") -> None:
    if detect not in DETECT_ROUTES:
        raise ValueError(f"detect must be one of {DETECT_ROUTES}, "
                         f"got {detect!r}")
    if cfg.filter_max_extrema > 0:
        raise NotImplementedError("grid filter (ROADMAP A4)")
    if cfg.desc_mode != "loop":
        raise NotImplementedError(f"desc_mode {cfg.desc_mode!r} (ROADMAP A9)")


def extract(img, plan: ExtractPlan, device, *, plain: bool = False,
            detect: str = "fused", front: str = "level") -> SiftFeatures:
    """Run the full pipeline on one [H, W] uint8 (or [0, 1] float32)
    image, given as a numpy array or tensor, on ``device``. ``detect``
    and ``front`` choose the detection route and the pyramid front (see
    the module docstring).

    On a CUDA device every kernel stage runs its CUDA kernel. ``plain``
    runs every stage's plain PyTorch version instead, on the same device:
    the baseline the kernels are timed against. It is never chosen on
    its own."""
    cfg = plan.config
    _check_supported(cfg, detect)
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img)).to(dev)
    if tuple(img.shape) != (plan.height, plan.width):
        raise ValueError(f"image {tuple(img.shape)} does not match the plan "
                         f"({plan.height}, {plan.width})")
    caps = plan.ext_caps
    dims = plan.pyramid.dims
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)

    blurs, dogs = build_pyramid(img, plan.pyramid, plain, front)

    # detection: one mask launch for all octaves, compaction per octave,
    # the refinement per octave (fused: K2 on the stack) or once over all
    # octaves' windows, one batched accept test over all octaves (each row
    # carries its octave's dims)
    octv_row = np.concatenate(
        [np.full(caps[o], o, np.int64) for o in range(len(caps))])
    w_row = torch.as_tensor(np.concatenate(
        [np.full(caps[o], ow, np.int64) for o, (_, ow) in enumerate(dims)]),
        device=dev)
    h_row = torch.as_tensor(np.concatenate(
        [np.full(caps[o], oh, np.int64) for o, (oh, _) in enumerate(dims)]),
        device=dev)
    masks = _ext.candidate_masks(dogs, cfg, plain=plain)
    cands = [_ext.collect_candidates(dog, cfg, caps[o], plain,
                                     windows=detect == "windows",
                                     mask=masks[o][0])
             for o, dog in enumerate(dogs)]
    if detect == "windows":
        n_found = torch.stack([c.n_found for c in cands]).tolist()
        state = _ext.refine_patches(
            torch.cat([c.patches for c in cands]),
            torch.cat([c.x0 for c in cands]), torch.cat([c.y0 for c in cands]),
            torch.cat([c.z0 for c in cands]),
            torch.cat([c.valid for c in cands]), cfg, w_row, h_row)
    else:
        n_found = [int(c.n_found) for c in cands]
        state = torch.cat([_ext.refine_candidates(dogs[o], c, cfg, plain)
                           for o, c in enumerate(cands)])
    g = _ext.finalize_refined(
        state, torch.cat([c.valid for c in cands]), cfg, w_row, h_row,
        sum(n_found), torch.stack([c.n_dropped for c in cands]).sum())

    # orientation: one K3 launch over the rows of all octaves (the kernel
    # reads ``valid`` and zeroes the other rows), one batched peak tail
    hist = _ori.orientation_histograms_octaves(blurs, g, cfg, offs[1:],
                                               plain=plain)
    oris = _ori.orientations_from_histograms(hist, g.valid,
                                             smoothing=cfg.ori_smoothing)

    # descriptors: one segmented job build, one K4 launch over the rows of
    # all octaves (the kernel reads ``valid``; no count comes back)
    segs = tuple((int(offs[o]), caps[o], plan.job_caps[o])
                 for o in range(len(caps)))
    jobs_all, _ = _desc.make_descriptor_jobs_segmented(
        g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid, segs)
    jobs_off = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)
    raw = _desc.compute_descriptors_octaves(blurs, jobs_all, jobs_off[1:],
                                            cfg, plain)
    desc_kp = jobs_all.kp_index + torch.as_tensor(
        np.repeat(offs[:-1], plan.job_caps), device=dev)

    desc_valid = jobs_all.valid
    desc = _desc.normalize_descriptors(raw, cfg)
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
        desc_kp=desc_kp,
        desc_valid=desc_valid,
        n_keypoints=g.valid.sum(),
        n_descriptors=desc_valid.sum(),
        octave_candidates=torch.stack([c.n_found for c in cands]),
        octave_dropped=torch.stack([c.n_dropped for c in cands]),
    )


def extract_batch(imgs, plan: ExtractPlan, device, *, plain: bool = False,
                  detect: str = "fused",
                  front: str = "level") -> SiftFeatures:
    """Run the pipeline on F same-sized frames at once, ``imgs`` [F, H, W]
    uint8 (or [0, 1] float32) as a numpy array or tensor, on ``device``.
    Every output gains a leading [F] axis; frame f's row equals
    ``extract`` of that frame. ``plain``, ``detect`` and ``front`` as in
    :func:`extract`."""
    cfg = plan.config
    _check_supported(cfg, detect)
    dev = resolve_device(device)
    imgs = torch.as_tensor(np.asarray(imgs)).to(dev)
    if imgs.dim() != 3 or tuple(imgs.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"frames {tuple(imgs.shape)} do not match the plan "
                         f"(F, {plan.height}, {plan.width})")
    F = imgs.shape[0]
    L = cfg.total_levels
    caps = plan.ext_caps
    dims = plan.pyramid.dims
    n_oct = len(caps)
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    Ktot = int(offs[-1])

    # frames stacked on the layer axis: [F, L, H, W] -> [F*L, H, W]
    blurs, dogs = build_pyramid_frames(imgs, plan.pyramid, plain, front)
    blurs = [b.view(F * L, *b.shape[2:]) for b in blurs]
    dogs = [d.view(F * (L - 1), *d.shape[2:]) for d in dogs]

    # detection: one mask launch for all octaves and frames, the
    # refinement once per octave (fused: K2's batched entry) or once over
    # all frames' and octaves' windows, one accept test over everything.
    # Rows are frame-major: frame f's octaves back to back.
    octv_row = np.concatenate(
        [np.full(caps[o], o, np.int64) for o in range(n_oct)])
    w_row = torch.as_tensor(np.tile(np.concatenate(
        [np.full(caps[o], ow, np.int64) for o, (_, ow) in enumerate(dims)]),
        F), device=dev)
    h_row = torch.as_tensor(np.tile(np.concatenate(
        [np.full(caps[o], oh, np.int64) for o, (oh, _) in enumerate(dims)]),
        F), device=dev)

    def frame_major(per_octave):
        """[F*cap_o, ...] per octave -> [F*Ktot, ...]."""
        return torch.cat([a.view(F, caps[o], *a.shape[1:])
                          for o, a in enumerate(per_octave)], 1).flatten(0, 1)

    masks = _ext.candidate_masks(dogs, cfg, F, plain)
    if detect == "windows":
        cands = [_ext.collect_candidates_batched(
            dogs[o], F, cfg, caps[o], plain, windows=True, mask=masks[o])
            for o in range(n_oct)]
        valid_rows = torch.cat([c.valid for c in cands], 1).reshape(-1)
        vals = _ext.refine_patches(
            frame_major([c.patches for c in cands]),
            frame_major([c.x0 for c in cands]),
            frame_major([c.y0 for c in cands]),
            frame_major([c.z0 for c in cands]), valid_rows, cfg, w_row, h_row)
    else:
        cands = [_ext.collect_refined_batched(dogs[o], F, cfg, caps[o], plain,
                                              mask=masks[o])
                 for o in range(n_oct)]
        valid_rows = torch.cat([c.valid for c in cands], 1).reshape(-1)
        vals = frame_major([c.vals for c in cands])
    n_found = torch.stack([c.n_found for c in cands]).tolist()  # [o][f]
    g = _ext.finalize_refined(
        vals, valid_rows, cfg, w_row, h_row,
        int(np.sum(n_found)), torch.stack([c.n_dropped for c in cands]).sum())

    # orientation: one K3 launch over the frame-major rows of all frames
    # and octaves; the kernel takes frame f's level l as layer f*L + l of
    # the stacked blur and zeroes the rows that are not valid
    hist = _ori.orientation_histograms_octaves(blurs, g, cfg, offs[1:], F,
                                               plain)
    oris = _ori.orientations_from_histograms(hist, g.valid,
                                             smoothing=cfg.ori_smoothing)

    # descriptors: one job build over all (octave, frame) segments, then
    # one K4 launch over every row (octave-major: octave o's F segments
    # end at row F * jobs_off[o + 1])
    segs, lev_offs = [], []
    for o in range(n_oct):
        for f in range(F):
            segs.append((f * Ktot + int(offs[o]), caps[o], plan.job_caps[o]))
            lev_offs.append(f * L)
    jobs_all, _ = _desc.make_descriptor_jobs_segmented(
        g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid, tuple(segs),
        level_offsets=tuple(lev_offs))
    jobs_off = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)
    Jtot = int(jobs_off[-1])
    raw_all = _desc.compute_descriptors_octaves(
        blurs, jobs_all, jobs_off[1:] * F, cfg, plain)
    raw, job_kps, job_valids = [], [], []
    for o in range(n_oct):
        jcap = plan.job_caps[o]
        jsl = slice(int(jobs_off[o]) * F, int(jobs_off[o]) * F + F * jcap)
        raw.append(raw_all[jsl].view(F, jcap, 128))
        job_kps.append(jobs_all.kp_index[jsl].view(F, jcap) + int(offs[o]))
        job_valids.append(jobs_all.valid[jsl].view(F, jcap))

    desc_valid = torch.cat(job_valids, 1)                  # [F, Jtot]
    desc = _desc.normalize_descriptors(
        torch.cat(raw, 1).reshape(F * Jtot, 128), cfg)
    desc = torch.where(desc_valid.reshape(-1)[:, None], desc,
                       torch.zeros_like(desc))

    scale_row = torch.as_tensor(np.tile(
        np.exp2(octv_row.astype(np.float32)
                - np.float32(cfg.upscale_factor)).astype(np.float32), F),
        device=dev)
    valid = g.valid.view(F, Ktot)
    return SiftFeatures(
        x=(g.x * scale_row).view(F, Ktot),
        y=(g.y * scale_row).view(F, Ktot),
        sigma=(g.sigma * scale_row).view(F, Ktot),
        octave=torch.as_tensor(np.tile(octv_row, (F, 1)), device=dev),
        num_ori=oris.num_ori.view(F, Ktot),
        valid=valid,
        ori=oris.ori.view(F, Ktot, -1),
        ori_valid=oris.ori_valid.view(F, Ktot, -1),
        desc=desc.view(F, Jtot, 128),
        desc_kp=torch.cat(job_kps, 1),
        desc_valid=desc_valid,
        n_keypoints=valid.sum(1),
        n_descriptors=desc_valid.sum(1),
        octave_candidates=torch.stack([c.n_found for c in cands], 1),
        octave_dropped=torch.stack([c.n_dropped for c in cands], 1),
    )


def frame_features(feats: SiftFeatures, f: int) -> SiftFeatures:
    """Frame ``f`` of a batched result (the leading axis dropped)."""
    return SiftFeatures(*(a[f] for a in feats))


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


def make_probe_fn(plan: ExtractPlan, device, front: str = "level"):
    """Detect-only probe (pipeline.py:787-804): pyramid and the dense
    candidate collection (one mask launch of K1 over the octaves' dense
    stacks, compaction per octave), no refinement or later stage, so of the two
    route keywords only ``front`` applies. The returned function maps
    one image to its per-octave candidate counts, i64 numpy
    [n_octaves]."""
    cfg = plan.config
    dev = resolve_device(device)

    def probe(img) -> np.ndarray:
        img = torch.as_tensor(np.asarray(img)).to(dev)
        _, dogs = build_pyramid(img, plan.pyramid, front=front)
        masks = _ext.candidate_masks(dogs, cfg)
        cands = [_ext.collect_candidates(dog, cfg, plan.ext_caps[o],
                                         mask=masks[o][0])
                 for o, dog in enumerate(dogs)]
        return torch.stack([c.n_found for c in cands]).cpu().numpy()

    return probe


def calibrate_plan(config: SiftConfig, frames, height: int | None = None,
                   width: int | None = None, headroom: float = 1.5,
                   probe_capacity: int = 8192, *, device,
                   front: str = "level") -> ExtractPlan:
    """Plan with per-octave capacities pinned from the candidate counts
    of representative ``frames`` on ``device``, as
    popsift_tpu.pipeline.calibrate_plan (:807-831) sizes them: the
    per-octave maximum times ``headroom``, rounded up to a multiple of
    128, plus 128, at least 256."""
    frames = list(frames)
    if height is None or width is None:
        height, width = np.asarray(frames[0]).shape[-2:]
    probe_cfg = config.replace(extrema_capacity=probe_capacity)
    probe = make_probe_fn(build_extract_plan(probe_cfg, height, width),
                          device, front)
    cand = np.zeros(len(config.octave_dims(width, height)), np.int64)
    for f in frames:
        cand = np.maximum(cand, probe(f))
    caps = tuple(int(max(256, -(-int(c * headroom) // 128) * 128 + 128))
                 for c in cand)
    return build_extract_plan(config, height, width, octave_caps=caps)
