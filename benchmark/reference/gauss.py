"""The configuration arithmetic and Gauss filter tables the reference needs.

A copy of the formulas of ``popsift_tpu_torch/config.py`` (octave count
and sizes, thresholds, the auto capacity rule) and of
``popsift_tpu_torch/gauss.py`` (``gauss_span``, ``gauss_filter``, the
``inc`` and ``dd`` banks) for the one strategy the benchmark's
configurations use: VLFeat filters, incremental blur, indirect scaling.
It imports nothing of the program, so the reference takes neither its
plan nor its tables; both are worked out again here from the
configuration's fields (reference: sift_conf.cu:17-39,
gauss_filter.cu:127-369, popsift.cpp:107-117).
"""

from __future__ import annotations

import math

import numpy as np

GAUSS_ALIGN = 32
MAX_OCTAVES = 20

# SiftConfig()'s defaults (sift_conf.cu:17-39 and the port's static-shape
# knobs); a configuration file overrides any of them
DEFAULTS = dict(
    octaves=-1, levels=3, sigma=1.6, edge_limit=10.0, threshold=0.04,
    upscale_factor=1.0, gauss_mode="vlfeat", sift_mode="popsift",
    scaling_mode="indirect", downscale_mode="pick", desc_mode="loop",
    norm_mode="rootsift", norm_multiplier=0, assume_initial_blur=True,
    initial_blur=0.5, max_extrema=100000, filter_max_extrema=-1,
    ori_smoothing="vlfeat", extrema_capacity=-1, extrema_capacity_cap=16384,
    compact_block_k=0, dtype="float32")

# what this reference implements; anything else is refused
SUPPORTED = dict(gauss_mode="vlfeat", sift_mode="popsift",
                 scaling_mode="indirect", downscale_mode="pick",
                 desc_mode="loop", norm_mode="rootsift",
                 ori_smoothing="vlfeat", filter_max_extrema=-1,
                 dtype="float32", assume_initial_blur=True)


class Params:
    """The fields of a configuration file's ``sift`` object over
    ``DEFAULTS``, and the quantities derived from them."""

    def __init__(self, fields: dict):
        unknown = set(fields) - set(DEFAULTS) - {"verbose",
                                                 "grid_filter_mode",
                                                 "filter_grid_size"}
        if unknown:
            raise ValueError(f"unknown configuration fields {sorted(unknown)}")
        f = {**DEFAULTS, **fields}
        for k, v in SUPPORTED.items():
            if f[k] != v:
                raise ValueError(f"the reference implements {k}={v!r}, "
                                 f"not {f[k]!r}")
        self.__dict__.update(f)

    @property
    def total_levels(self) -> int:
        return self.levels + 3

    @property
    def peak_threshold(self) -> float:
        return self.threshold * 0.5 * 255.0 / self.levels

    @property
    def sigma_k(self) -> float:
        return 2.0 ** (1.0 / self.levels)

    def octave_dims(self, width: int, height: int) -> list:
        """(height, width) of each octave (popsift.cpp:107-117)."""
        s = 2.0 ** self.upscale_factor
        if self.octaves > 0:
            n = min(self.octaves, MAX_OCTAVES)
        else:
            n = int(math.floor(math.log(min(width, height)) / math.log(2.0))
                    - 3.0 + s)
            n = max(min(n, MAX_OCTAVES), 1)
        w, h = math.ceil(width * s), math.ceil(height * s)
        dims = []
        for _ in range(n):
            dims.append((h, w))
            w, h = math.ceil(w / 2.0), math.ceil(h / 2.0)
        return dims

    def capacity(self, oct_h: int, oct_w: int) -> int:
        """The program's candidate capacity of an octave: the pinned
        capacity, or one slot per 128 pixels (at least 512, at most the
        cap). The reference keeps every candidate; this gives the padded
        rows the rooflines count and the candidates a capacity drops."""
        if self.extrema_capacity > 0:
            return min(self.extrema_capacity, self.max_extrema)
        auto = max(512, (oct_h * oct_w) // 128)
        return int(min(auto, self.extrema_capacity_cap, self.max_extrema))


def gauss_span(sigma: float) -> int:
    """VLFeat half-span, centre included (gauss_filter.cu:302-308)."""
    return min(int(math.ceil(4.0 * sigma) + 1), GAUSS_ALIGN - 1)


def gauss_filter(sigma: float, span: int) -> np.ndarray:
    """Half-sided Gaussian normalised so centre + 2 sum(taps) = 1
    (gauss_filter.cu:344-369), float32 as the tables hold it."""
    out = np.zeros(GAUSS_ALIGN, dtype=np.float64)
    out[0] = 1.0
    s = 1.0
    for x in range(1, span):
        v = math.exp(-0.5 * (float(x) / sigma) ** 2)
        out[x] = v
        s += 2.0 * v
    out[:span] /= s
    return out.astype(np.float32)


def filter_tables(p: Params) -> dict:
    """``inc`` (level to level) and ``dd[0]`` (input to octave 0) half
    filters with their spans (gauss_filter.cu:169-237)."""
    sigma0, levels, stages = p.sigma, p.levels, p.total_levels
    initial_blur = p.initial_blur * 2.0 ** p.upscale_factor
    inc_sigma = [math.sqrt(abs(sigma0 ** 2 - initial_blur ** 2))]
    for lvl in range(1, stages):
        s_prev = sigma0 * 2.0 ** ((lvl - 1) / levels)
        s_next = sigma0 * 2.0 ** (lvl / levels)
        inc_sigma.append(math.sqrt(s_next ** 2 - s_prev ** 2))
    inc_span = [gauss_span(s) for s in inc_sigma]
    dd0_sigma = math.sqrt(abs(sigma0 ** 2 - initial_blur ** 2))
    dd0_span = gauss_span(dd0_sigma)
    return dict(inc=[gauss_filter(s, n) for s, n in zip(inc_sigma, inc_span)],
                inc_span=inc_span, dd0=gauss_filter(dd0_sigma, dd0_span),
                dd0_span=dd0_span)
