"""Roofline arithmetic: the least time one NVIDIA H100 SXM could take for
a kernel's work, from the work's shapes and counts.

A copy of ``chip_smoke.py``'s ``bound_ms``, ``refine_bound``,
``ori_bound``, ``desc_bound``, its K1 mask bound, compaction bound and
K5 level and thin-entry bounds, and phase 7's matcher bound: each input
byte read once and each output byte written once, or the nominal f32
operations, whichever takes longer at the data sheet's rates. The
benchmark imports neither ``chip_smoke.py`` nor the program for them.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA's data sheet for the H100 SXM: HBM3 bandwidth and the f32 rate
# outside the tensor cores (every kernel here is plain f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# the program's thin-octave entry of K5 (ops/kernels/blur_dog.py:
# THIN_PIXELS, THIN_MAX_OCTAVES, THIN_MAX_LEVELS, MAX_S): the trailing
# octaves of at most 4096 pixels take one launch for all their levels
THIN_PIXELS = 4096
THIN_MAX_OCTAVES = 8
THIN_MAX_LEVELS = 12
THIN_MAX_HALF = 24


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds to move ``n_bytes`` or to do ``n_ops`` f32 operations,
    whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S)


def first_thin_octave(dims, half_spans, levels_searched: int) -> int:
    """The first octave that K5's thin entry blurs (``len(dims)`` if
    none): the longest run of trailing octaves of at most THIN_PIXELS
    pixels, at most THIN_MAX_OCTAVES of them (ops/pyramid.py
    ``first_thin_octave`` for the incremental pick strategy)."""
    n = len(dims)
    first = n
    fits = (levels_searched >= 1
            and 1 <= len(half_spans) <= THIN_MAX_LEVELS
            and all(s <= THIN_MAX_HALF for s in half_spans))
    while (fits and first > 0 and n - first < THIN_MAX_OCTAVES
           and dims[first - 1][0] * dims[first - 1][1] <= THIN_PIXELS):
        first -= 1
    return first


def front_bound(dims, half_spans, frames: int = 1) -> float:
    """K5 over a frame's pyramid, levels 1..L-1 of every octave: a level
    launch reads its source level and writes the level and its DoG (12
    bytes a pixel) and the next octave's level 0 where it picks it; the
    thin entry reads the first thin octave's level 0 and writes every
    level and DoG of the thin octaves and their levels 0; operations: two
    passes of 1 + 3 S and the DoG's subtraction a pixel and level, S the
    filter's half-width (``half_spans``, levels 1..L-1)."""
    px = [h * w for h, w in dims]
    n_lv = len(half_spans)
    ft = first_thin_octave(dims, half_spans, n_lv - 2)
    ops = sum(p * (2 * (1 + 3 * s) + 1) for p in px for s in half_spans)
    nbytes = 0
    for o in range(ft):
        nbytes += 12 * px[o] * n_lv
        if o + 1 < len(px):
            nbytes += 4 * px[o + 1]
    if ft < len(px):
        thin = px[ft:]
        nbytes += 4 * thin[0] + sum(8 * n_lv * p for p in thin) \
            + sum(4 * p for p in thin[1:])
    return frames * bound_s(nbytes, ops)


def mask_bound(dims, levels_searched: int, frames: int = 1) -> float:
    """K1: Z + 2 f32 DoG layers read and Z u8 mask layers written, 30
    operations a tested pixel (26 comparisons, the gate, their
    combination)."""
    Z = levels_searched
    px = [h * w for h, w in dims]
    return bound_s(frames * sum(((Z + 2) * 4 + Z) * p for p in px),
                   frames * sum(30 * Z * p for p in px))


def compact_bound(dims, levels_searched: int, caps, frames: int = 1) -> float:
    """The compaction: every mask byte read, three i32 rows written a
    capacity row and the counts an octave; one operation a mask entry."""
    n = frames * sum(levels_searched * h * w for h, w in dims)
    return bound_s(n + frames * (12 * sum(caps) + 16 * len(caps)), n)


def refine_bound(n_live: int, n_rows: int) -> float:
    """K2: a live candidate's coordinates and 27 neighbours read, its
    16-float state written for every capacity row; about 150 operations
    a candidate (one step)."""
    return bound_s(n_live * (12 + 27 * 4) + n_rows * 64, n_live * 150)


def ori_bound(sigma: np.ndarray, n_rows: int) -> float:
    """K3 for valid rows of octave scale ``sigma``: the window of radius
    round(4.5 sigma) with its gradient margin read once, 36 bins written
    for every row; about 40 operations a window pixel."""
    rad = np.round(np.asarray(sigma, np.float64) * 4.5)
    return bound_s(float(((2 * rad + 3) ** 2).sum()) * 4 + n_rows * 36 * 4,
                   float(((2 * rad + 1) ** 2).sum()) * 40)


def desc_bound(sigma: np.ndarray, radius: int, n_rows: int) -> float:
    """K4 for valid jobs of octave scale ``sigma``: a support of
    half-side ceil(2.5 sqrt(2) 3 sigma) + 2 (at most ``radius``) with its
    gradient margin read once, 128 bins written for every row; about 90
    operations a support pixel."""
    sup = np.minimum(np.ceil(np.asarray(sigma, np.float64)
                             * (3.0 * 2.5 * math.sqrt(2.0))) + 2, radius)
    return bound_s(float(((2 * sup + 3) ** 2).sum()) * 4 + n_rows * 128 * 4,
                   float(((2 * sup + 1) ** 2).sum()) * 90)


def loop_radius(p) -> int:
    """K4's static window radius for configuration ``p``: the support of
    the largest scale, sigma at level total - 1.5 (ops/descriptors.py
    ``loop_patch_radius``, s_desc_loop.cu:58-91)."""
    sigma_max = p.sigma * 2.0 ** ((p.total_levels - 1.5) / p.levels)
    return int(math.ceil(2.5 * math.sqrt(2.0) * 3.0 * sigma_max)) + 2


def match_bound(n_left: int, n_right: int) -> float:
    """The exact matcher over padded sets: 2 x 128 operations a
    (left, right) pair, or the distance field's f32 bytes."""
    return bound_s(4.0 * n_left * n_right, 2.0 * 128 * n_left * n_right)
