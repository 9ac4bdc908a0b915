"""Keypoint orientation assignment in PyTorch.

Port of :mod:`popsift_tpu.ops.orientation`: the raw 36-bin histogram runs
as kernel K3 (ops/kernels/orient.py), one launch for all octaves of a
frame or batch (:func:`orientation_histograms_octaves`); smoothing,
parabolic peak refinement and the 0.8-max acceptance of at most four
peaks (s_orientation.cu:142-241) are [K, 36] tensor math run once over
all octaves. :func:`assign_orientations` is the JAX package's public
one-octave form: K3's one-octave entry over all K rows, then the tail.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import ORI_NBINS, ORI_WINFACTOR, ORIENTATION_MAX_COUNT, SiftConfig
from ..utils.f32 import div
from .extrema import OctaveExtrema
from .kernels.orient import (orientation_hist, orientation_hist_octaves,
                             orientation_hist_octaves_torch,
                             orientation_hist_torch)


class OctaveOrientations(NamedTuple):
    ori: torch.Tensor        # f32[K, 4] angles, descending peak order
    ori_valid: torch.Tensor  # bool[K, 4]
    num_ori: torch.Tensor    # i64[K]


def max_ori_radius(cfg: SiftConfig) -> int:
    """Static window radius bound round(3 * 1.5 * sigma_max), sigma_max at
    the verify() bound sn <= maxlevel (s_extrema.cu:286-297)."""
    sigma_max = cfg.sigma * 2.0 ** ((cfg.total_levels - 1) / cfg.levels)
    return int(round(3.0 * ORI_WINFACTOR * sigma_max))


def orientation_histograms(blur: torch.Tensor, ext: OctaveExtrema,
                           cfg: SiftConfig, n: int,
                           plain: bool = False,
                           y_bounds=None) -> torch.Tensor:
    """Raw f32[K, 36] histograms of one octave's keypoint rows (kernel K3,
    or its plain version with ``plain``); rows at or past ``n`` (the
    octave's candidate count, beyond which no row is valid) and invalid
    rows are zero. ``y_bounds``: inclusive scan rows of a row band, as
    JAX's (:52-65)."""
    fn = orientation_hist_torch if plain else orientation_hist
    return fn(blur, ext.x, ext.y, ext.sigma, ext.level, ext.valid, n,
              max_ori_radius(cfg), y_bounds=y_bounds)


def orientation_histograms_octaves(blurs, ext: OctaveExtrema,
                                   cfg: SiftConfig, row_ends, F: int = 1,
                                   plain: bool = False, y_offsets=None,
                                   y_bounds=None) -> torch.Tensor:
    """Raw f32[K, 36] histograms of the keypoint rows of all octaves of F
    frames in one launch of kernel K3 (or its plain version with
    ``plain``). ``blurs``: per octave the frames' blur stacks back to
    back on the layer axis; the rows of ``ext`` are frame-major, each
    frame's octave o ending at row ``row_ends[o]`` of the frame, and
    ``ext.level`` indexes the frame's own layers. Rows that are not
    valid are zero. A row band passes its octaves' global row offsets
    and scan rows (``y_offsets``, ``y_bounds``: K3's row bounds)."""
    fn = orientation_hist_octaves_torch if plain else orientation_hist_octaves
    return fn(blurs, row_ends, ext.x, ext.y, ext.sigma, ext.level, ext.valid,
              max_ori_radius(cfg), F, y_offsets=y_offsets, y_bounds=y_bounds)


def smooth_histograms(hist: torch.Tensor, smoothing: str = "vlfeat"
                      ) -> torch.Tensor:
    """Circular smoothing of [K, 36] histograms: "vlfeat" = 3 x two
    box-3 passes (s_orientation.cu:142-156), "opencv" = one binomial
    [1 4 6 4 1]/16 pass (:158-173)."""
    r = torch.roll
    if smoothing == "opencv":
        return (r(hist, 2, 1) + r(hist, -2, 1)
                + 4.0 * (r(hist, 1, 1) + r(hist, -1, 1))
                + 6.0 * hist) / 16.0
    for _ in range(6):
        hist = div(r(hist, 1, 1) + hist + r(hist, -1, 1), 3.0)
    return hist


def _top_bins(vals: torch.Tensor, k: int):
    """(values, bins) of the ``k`` largest entries of each row, largest
    first, ties toward the lower bin, by ``k`` rounds of ``max``."""
    top_val, top_idx = [], []
    for r in range(k):
        v, i = vals.max(1)
        top_val.append(v)
        top_idx.append(i)
        if r + 1 < k:
            vals = vals.scatter(1, i[:, None], -math.inf)
    return torch.stack(top_val, 1), torch.stack(top_idx, 1)


def orientations_from_histograms(hist: torch.Tensor, valid: torch.Tensor,
                                 smoothing: str = "vlfeat"
                                 ) -> OctaveOrientations:
    """Smoothing + peak refinement + 0.8-max acceptance over [K, 36]
    histograms, port of popsift_tpu.ops.orientation
    .orientations_from_histograms (:192-231).

    ``lax.top_k`` breaks ties toward the lower index and ``torch.topk``
    promises no order, so the top four come from four rounds of
    ``max`` (which returns the first maximal bin), each round's bin then
    excluded: the order of a stable descending sort wherever the value is
    finite, without sorting all 36 bins of every row. Only finite peaks
    are accepted, so the order among ``-inf`` bins never reaches an
    output. The order of orientations decides the order of descriptor
    jobs."""
    hist = smooth_histograms(hist, smoothing)
    prev = torch.roll(hist, 1, 1)
    nxt = torch.roll(hist, -1, 1)
    peak = hist > torch.maximum(prev, nxt)
    num = 3.0 * prev - 4.0 * hist + nxt
    denB = torch.where(peak, 2.0 * (prev - 2.0 * hist + nxt),
                       torch.ones_like(hist))
    newbin = num / denB
    ok = peak & (newbin >= 0.0) & (newbin <= 2.0)
    bins = torch.arange(ORI_NBINS, dtype=torch.float32, device=hist.device)
    refined = torch.where(
        ok, torch.remainder(bins - 1.0, float(ORI_NBINS)) + newbin,
        torch.full_like(hist, -1.0))
    yval = torch.where(ok, -(num * num) / (4.0 * denB) + prev,
                       torch.full_like(hist, -math.inf))

    top_val, top_idx = _top_bins(yval, ORIENTATION_MAX_COUNT)
    best = top_val[:, :1]
    accept = (top_val >= 0.8 * best) & torch.isfinite(top_val) \
        & valid[:, None]

    chosen = torch.gather(refined, 1, top_idx)
    chosen = torch.where(chosen >= ORI_NBINS, chosen - ORI_NBINS, chosen)
    th = div(chosen * float(np.float32(2.0 * math.pi)), float(ORI_NBINS)) \
        - float(np.float32(math.pi))
    return OctaveOrientations(
        ori=torch.where(accept, th, torch.zeros_like(th)),
        ori_valid=accept,
        num_ori=accept.sum(1),
    )


def assign_orientations(blur: torch.Tensor, ext: OctaveExtrema,
                        cfg: SiftConfig,
                        y_bounds=None) -> OctaveOrientations:
    """Up to four orientations of each (padded) extremum of one octave:
    the histograms (kernel K3's one-octave entry over all K rows, which
    zeroes the rows that are not valid, so no count is read back), then
    :func:`orientations_from_histograms`; port of
    popsift_tpu.ops.orientation.assign_orientations (:234-244).
    ``y_bounds`` as in :func:`orientation_histograms`."""
    hist = orientation_histograms(blur, ext, cfg, ext.x.shape[0],
                                  y_bounds=y_bounds)
    return orientations_from_histograms(hist, ext.valid,
                                        smoothing=cfg.ori_smoothing)
