"""Scalar NumPy SIFT oracle.

A deliberately simple, loop-heavy re-implementation of the reference
algorithm used ONLY as the golden value source for the port's tests and
for ``chip_smoke.py``, which holds the card to it. It is the port's own
copy of :mod:`popsift_tpu.oracle.sift_oracle`, class for class and
function for function (tests/test_torch_imports.py holds the sources
together); only this docstring differs. Every stage cites the reference
file:line whose observable behavior it reproduces. It stays scalar f64
NumPy: no import from popsift_tpu_torch.ops, nor from anything that
imports torch, so that it shares no arithmetic with the code it judges.
Its ``..config`` and ``..gauss`` are the port's copies, which import
neither.

Supported configuration: gauss_mode="vlfeat" (VLFeat_Compute) or the
fixed9/fixed15 modes, scaling_mode="indirect", sift_mode in {"popsift",
"vlfeat"}. These are the reference defaults and the golden-test
configurations (testScripts/testOxfordDataset.sh.in:48).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..config import (
    DESC_BINS,
    DESC_MAGNIFY,
    ORI_NBINS,
    ORI_WINFACTOR,
    ORIENTATION_MAX_COUNT,
    SiftConfig,
)
from ..gauss import GaussTables, build_gauss_tables

F32 = np.float32


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

def _bilinear_clamped(row_img: np.ndarray, px: np.ndarray) -> np.ndarray:
    """Sample 1-D positions ``px`` (pixel units) along the last axis with
    clamp-to-edge, matching CUDA normalized-coord linear textures
    (readTex convention, common/assist.h:66-81)."""
    n = row_img.shape[-1]
    px = np.clip(px, 0.0, n - 1.0)
    x0 = np.floor(px).astype(np.int64)
    x1 = np.minimum(x0 + 1, n - 1)
    f = (px - x0).astype(row_img.dtype)
    return row_img[..., x0] * (1.0 - f) + row_img[..., x1] * f


def _conv_half(img: np.ndarray, half: np.ndarray, span: int, axis: int) -> np.ndarray:
    """Separable convolution along ``axis`` with a half-sided filter and
    edge-replication boundary (readTex clamps, s_pyramid_build_aa.cu:31-48)."""
    img = np.moveaxis(img, axis, -1)
    n = img.shape[-1]
    pad = span - 1
    padded = np.pad(img, [(0, 0)] * (img.ndim - 1) + [(pad, pad)], mode="edge")
    out = padded[..., pad:pad + n] * half[0]
    for off in range(1, span):
        out = out + (padded[..., pad - off:pad - off + n]
                     + padded[..., pad + off:pad + off + n]) * half[off]
    return np.moveaxis(out, -1, axis)


def _resample_from_input(img: np.ndarray, dst_h: int, dst_w: int,
                         shift: float, half: np.ndarray, span: int) -> np.ndarray:
    """Octave-0 level-0 construction straight from the input image.

    Reproduces gauss::normalizedSource::horiz (s_pyramid_build_ra.cu:18-55)
    followed by gauss::absoluteSource::vert (s_pyramid_build_aa.cu:56-92):
    the horizontal pass samples the *source* texture at normalized
    coordinates (x + shift)/dst_w with taps spaced one destination pixel
    apart, bilinearly interpolated, output scaled by 255.
    """
    src_h, src_w = img.shape
    rx = src_w / dst_w
    ry = src_h / dst_h

    # horizontal: sample source rows at (x + shift) * rx - 0.5 +/- off * rx,
    # then the row positions (y + shift) * ry - 0.5 bilinear in y as well
    # (the input texture is 2-D linear; the horiz kernel reads at the
    # fractional y too, s_pyramid_build_ra.cu:37-38).
    ys = (np.arange(dst_h, dtype=np.float64) + shift) * ry - 0.5
    ys = np.clip(ys, 0.0, src_h - 1.0)
    y0 = np.floor(ys).astype(np.int64)
    y1 = np.minimum(y0 + 1, src_h - 1)
    fy = (ys - y0)[:, None]

    xs_base = (np.arange(dst_w, dtype=np.float64) + shift) * rx - 0.5
    out = np.zeros((dst_h, dst_w), dtype=np.float64)

    def sample_rows(px):
        r0 = _bilinear_clamped(img.astype(np.float64)[y0], px)
        r1 = _bilinear_clamped(img.astype(np.float64)[y1], px)
        return r0 * (1.0 - fy) + r1 * fy

    out += sample_rows(xs_base) * float(half[0])
    for off in range(1, span):
        out += (sample_rows(xs_base - off * rx)
                + sample_rows(xs_base + off * rx)) * float(half[off])
    out *= 255.0

    # vertical pass with the same sigma (vert_from_interm with inc[0];
    # inc.sigma[0] == dd.sigma[0], gauss_filter.cu:177-179 & 227-236)
    return out


def oracle_pyramid(img_u8: np.ndarray, config: SiftConfig,
                   tables: GaussTables | None = None):
    """Build blur + DoG pyramids.

    Returns (blurs, dogs): lists over octaves of float32 [L, H, W] and
    [L-1, H, W]. Reproduces the default build path of build_pyramid
    (s_pyramid_build.cu:546-596): octave 0 from the input image, higher
    octaves by decimating level ``levels`` (= total-3) of the previous
    octave, incremental blurs in between, DoG as adjacent differences.
    """
    if tables is None:
        tables = build_gauss_tables(config)
    fixed = config.gauss_mode in ("fixed9", "fixed15")
    assert config.gauss_mode == "vlfeat" or fixed, \
        "oracle supports vlfeat + fixed gauss modes"
    h, w = img_u8.shape
    if img_u8.dtype == np.uint8:
        img = img_u8.astype(np.float64) / 255.0
    else:
        # ImageFloat input mode: element values used as-is
        # (s_image.cu:264-293)
        img = img_u8.astype(np.float64)
    total = config.total_levels
    dims = config.octave_dims(w, h)

    # sub-pixel shift convention (s_pyramid_build.cu:109-123; fixed modes
    # always use 0.5 * 2^upscale, s_pyramid_fixed.cu:236)
    if config.sift_mode in ("popsift", "vlfeat") or fixed:
        shift0 = 0.5 * (2.0 ** config.upscale_factor)
    else:
        shift0 = 0.5

    def downscale(prev, oh, ow):
        if config.downscale_mode == "interpolate":
            # get_by_2_interpolate picks texel (2x+1, 2y+1) exactly
            # (s_pyramid_build.cu:33-49); clamp for odd sources
            ph, pw = prev.shape
            yi = np.minimum(2 * np.arange(oh) + 1, ph - 1)
            xi = np.minimum(2 * np.arange(ow) + 1, pw - 1)
            return prev[np.ix_(yi, xi)]
        return prev[0::2, 0::2][:oh, :ow]

    blurs = []
    dogs = []
    for octv, (oh, ow) in enumerate(dims):
        levels = np.zeros((total, oh, ow), dtype=np.float64)
        if fixed:
            # Fixed9/Fixed15 (s_pyramid_fixed.cu:202-288): octave 0 has
            # every level built from the input with abs_o0 (same filter
            # both axes); octaves >0 build levels 1.. from the
            # downscaled level 0 with abs_oN.
            if octv == 0:
                for lvl in range(total):
                    half = tables.abs_o0[lvl].astype(np.float64)
                    span = int(tables.abs_o0_span[lvl])
                    interm = _resample_from_input(img, oh, ow, shift0,
                                                  half, span)
                    levels[lvl] = _conv_half(interm, half, span, axis=0)
            else:
                prev = blurs[octv - 1][total - 3]
                levels[0] = downscale(prev, oh, ow)
                for lvl in range(1, total):
                    half = tables.abs_oN[lvl].astype(np.float64)
                    span = int(tables.abs_oN_span[lvl])
                    tmp = _conv_half(levels[0], half, span, axis=1)
                    levels[lvl] = _conv_half(tmp, half, span, axis=0)
            blurs.append(levels.astype(F32))
            dogs.append((levels[1:] - levels[:-1]).astype(F32))
            continue
        if octv == 0:
            interm = _resample_from_input(img, oh, ow, shift0,
                                          tables.dd[0], int(tables.dd_span[0]))
            levels[0] = _conv_half(interm, tables.inc[0].astype(np.float64),
                                   int(tables.inc_span[0]), axis=0)
        else:
            prev = blurs[octv - 1][total - 3]
            levels[0] = downscale(prev, oh, ow)
        for lvl in range(1, total):
            half = tables.inc[lvl].astype(np.float64)
            span = int(tables.inc_span[lvl])
            tmp = _conv_half(levels[lvl - 1], half, span, axis=1)
            levels[lvl] = _conv_half(tmp, half, span, axis=0)
        blurs.append(levels.astype(F32))
        dogs.append((levels[1:] - levels[:-1]).astype(F32))
    return blurs, dogs


# ---------------------------------------------------------------------------
# Extrema detection + refinement
# ---------------------------------------------------------------------------

@dataclass
class OracleExtremum:
    octave: int
    x: float          # octave coordinates
    y: float
    s: float          # continuous level
    level: int        # round(s)
    sigma: float      # octave-relative sigma
    cell: int = 0
    orientations: list = field(default_factory=list)
    descriptors: list = field(default_factory=list)


def _solve3(A: np.ndarray, b: np.ndarray):
    """Symmetric 3x3 solve via adjugate, float32 like s_solve.h:24-85.

    Returns (ok, x). ok is False iff det == 0 exactly (matching the
    reference's equality test, s_solve.h:56-58).
    """
    A = A.astype(F32)
    b = b.astype(F32)
    det0 = A[1, 1] * A[2, 2] - A[1, 2] * A[1, 2]
    det1 = A[1, 2] * A[0, 2] - A[0, 1] * A[2, 2]
    det2 = A[0, 1] * A[1, 2] - A[1, 1] * A[0, 2]
    det3 = A[0, 0] * A[2, 2] - A[0, 2] * A[0, 2]
    det4 = A[0, 1] * A[0, 2] - A[0, 0] * A[1, 2]
    det5 = A[0, 0] * A[1, 1] - A[0, 1] * A[0, 1]
    det = A[0, 0] * det0 + A[0, 1] * det1 + A[0, 2] * det2
    if det == 0.0:
        return False, np.zeros(3, F32)
    rsd = F32(1.0) / det
    inv = np.array([[det0, det1, det2],
                    [det1, det3, det4],
                    [det2, det4, det5]], dtype=F32) * rsd
    return True, inv @ b


def _read_dog(dog: np.ndarray, x: int, y: int, z: int) -> float:
    """Clamped read (readTex semantics, common/assist.h:66-81)."""
    L, H, W = dog.shape
    return dog[min(max(z, 0), L - 1), min(max(y, 0), H - 1), min(max(x, 0), W - 1)]


def _is_extremum_26(dog: np.ndarray, x: int, y: int, z: int) -> bool:
    """Strict 26-neighbor min/max test (s_extrema.cu:56-120)."""
    val = _read_dog(dog, x, y, z)
    neigh = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0 and dz == 0:
                    continue
                neigh.append(_read_dog(dog, x + dx, y + dy, z + dz))
    neigh = np.array(neigh)
    return bool(np.all(val > neigh) or np.all(val < neigh))


def oracle_extrema(dog: np.ndarray, config: SiftConfig, octave: int,
                   oct_w: int | None = None, oct_h: int | None = None):
    """Find + refine extrema in one octave's DoG stack.

    Reproduces find_extrema_in_dog_sub for PopSift/VLFeat modes
    (s_extrema.cu:300-504). Returns a list of OracleExtremum.
    """
    L, H, W = dog.shape
    oct_w = oct_w or W
    oct_h = oct_h or H
    mode = config.sift_mode
    thr = F32(config.peak_threshold)
    maxlevel = config.total_levels - 1
    sigma_k = config.sigma_k

    if mode in ("popsift", "vlfeat"):
        first_thr = 1.6 * thr  # popsift: 1.6*thr; vlfeat: 0.8*2*thr == same
    else:
        first_thr = math.floor(thr)

    w_div = oct_w / config.filter_grid_size
    h_div = oct_h / config.filter_grid_size

    found = []
    for z in range(1, config.total_levels - 3 + 1):
        for y in range(1, H - 1):
            for x in range(1, W - 1):
                val = dog[z, y, x]
                if abs(val) < first_thr:
                    continue
                if not _is_extremum_26(dog, x, y, z):
                    continue
                ext = _refine(dog, x, y, z, val, config, maxlevel)
                if ext is None:
                    continue
                xn, yn, sn = ext
                e = OracleExtremum(
                    octave=octave, x=xn, y=yn, s=sn,
                    level=int(round(sn)),
                    sigma=config.sigma * sigma_k ** sn,
                    cell=int(math.floor(yn / h_div) * config.filter_grid_size
                             + math.floor(xn / w_div)),
                )
                found.append(e)
    return found


def _refine(dog, x, y, z, val, config, maxlevel):
    """Quadratic 3-D refinement loop (s_extrema.cu:359-503)."""
    MAX_ITERATIONS = 5
    L, H, W = dog.shape
    width, height = W, H
    n = np.array([x, y, z], dtype=np.int64)
    v = F32(val)
    d = np.zeros(3, F32)
    D = np.zeros(3, F32)
    DD = np.zeros(3, F32)
    DX = np.zeros(3, F32)
    thr = F32(config.peak_threshold)
    mode = config.sift_mode

    it = 0
    while True:
        it += 1
        rd = lambda dx, dy, dz: F32(_read_dog(dog, n[0] + dx, n[1] + dy, n[2] + dz))
        D = np.array([0.5 * (rd(1, 0, 0) - rd(-1, 0, 0)),
                      0.5 * (rd(0, 1, 0) - rd(0, -1, 0)),
                      0.5 * (rd(0, 0, 1) - rd(0, 0, -1))], F32)
        c = rd(0, 0, 0)
        DD = np.array([rd(1, 0, 0) + rd(-1, 0, 0) - 2 * c,
                       rd(0, 1, 0) + rd(0, -1, 0) - 2 * c,
                       rd(0, 0, 1) + rd(0, 0, -1) - 2 * c], F32)
        DX = np.array([
            0.25 * (rd(1, 1, 0) + rd(-1, -1, 0) - rd(-1, 1, 0) - rd(1, -1, 0)),
            0.25 * (rd(1, 0, 1) + rd(-1, 0, -1) - rd(-1, 0, 1) - rd(1, 0, -1)),
            0.25 * (rd(0, 1, 1) + rd(0, -1, -1) - rd(0, 1, -1) - rd(0, -1, 1)),
        ], F32)
        A = np.array([[DD[0], DX[0], DX[1]],
                      [DX[0], DD[1], DX[2]],
                      [DX[1], DX[2], DD[2]]], F32)
        ok, sol = _solve3(A, -D)
        if not ok:
            d = np.zeros(3, F32)
            break
        d = sol

        last_it = (it == MAX_ITERATIONS)
        if mode == "vlfeat":
            # s_extrema.cu:207-232 (no level moves in VLFeat)
            if last_it:
                ret = 0
            else:
                tx = (1 if (d[0] >= 0.6 and n[0] < width - 2) else 0) + \
                     (-1 if (d[0] <= -0.6 and n[0] > 1) else 0)
                ty = (1 if (d[1] >= 0.6 and n[1] < height - 2) else 0) + \
                     (-1 if (d[1] <= -0.6 and n[1] > 1) else 0)
                if tx == 0 and ty == 0:
                    ret = 1
                else:
                    n[0] += tx
                    n[1] += ty
                    ret = 0
        else:  # popsift (s_extrema.cu:258-284)
            if last_it:
                ret = 0
            else:
                tx = (1 if (d[0] >= 0.6 and n[0] < width - 2) else 0) + \
                     (-1 if (d[0] <= -0.6 and n[0] > 1) else 0)
                ty = (1 if (d[1] >= 0.6 and n[1] < height - 2) else 0) + \
                     (-1 if (d[1] <= -0.6 and n[1] > 1) else 0)
                tz = (1 if (d[2] >= 0.6 and n[2] < maxlevel - 1) else 0) + \
                     (-1 if (d[2] <= -0.6 and n[2] > 1) else 0)
                if tx == 0 and ty == 0 and tz == 0:
                    ret = 1
                else:
                    n += np.array([tx, ty, tz])
                    ret = 0
        if ret == 1:
            break
        if it >= MAX_ITERATIONS:
            break

    # excessive movement reject (positive side only, s_extrema.cu:455-460)
    if d[0] >= 1.5 or d[1] >= 1.5 or d[2] >= 1.5:
        return None

    xn = float(n[0] + d[0])
    yn = float(n[1] + d[1])
    sn = float(n[2] + d[2])

    # verify (s_extrema.cu:234-245 / 286-297)
    if xn < 0.0 or xn > width - 1.0 or yn < 0.0 or yn > height - 1.0 \
            or sn < 0.0 or sn > maxlevel:
        return None

    contr = v + 0.5 * float(D @ d)
    tr = float(DD[0] + DD[1])
    det = float(DD[0] * DD[1] - DX[0] * DX[0])
    if det <= 0.0:
        return None
    if abs(contr) < 2.0 * float(thr):
        return None
    e = config.edge_limit
    if tr * tr / det >= (e + 1.0) * (e + 1.0) / e:
        return None
    return xn, yn, sn


# ---------------------------------------------------------------------------
# Orientation
# ---------------------------------------------------------------------------

def _gradient(blur_level: np.ndarray, x: int, y: int):
    """Central-difference gradient with clamped reads (s_gradiant.h:55-69)."""
    H, W = blur_level.shape
    cx = lambda v: min(max(v, 0), W - 1)
    cy = lambda v: min(max(v, 0), H - 1)
    dx = blur_level[cy(y), cx(x + 1)] - blur_level[cy(y), cx(x - 1)]
    dy = blur_level[cy(y + 1), cx(x)] - blur_level[cy(y - 1), cx(x)]
    return math.hypot(dx, dy), math.atan2(dy, dx)


def oracle_orientations(blur: np.ndarray, ext: OracleExtremum,
                        config: SiftConfig) -> list[float]:
    """Orientation histogram + peak extraction (ori_par, s_orientation.cu:60-242).

    Uses VLFeat smoothing (3x double box-3, WITH_VLFEAT_SMOOTHING default).
    Returns up to ORIENTATION_MAX_COUNT angles, ordered by descending peak
    value.
    """
    L, H, W = blur.shape
    layer = blur[ext.level]
    x, y, sig = ext.x, ext.y, ext.sigma
    sigw = ORI_WINFACTOR * sig
    rad = int(round(3.0 * sigw))
    factor = -0.5 / (sigw * sigw)
    sq_thres = rad * rad

    xmin = max(1, int(round(x)) - rad)
    xmax = min(W - 2, int(round(x)) + rad)
    ymin = max(1, int(round(y)) - rad)
    ymax = min(H - 2, int(round(y)) + rad)

    hist = np.zeros(ORI_NBINS, dtype=np.float64)
    for yy in range(ymin, ymax + 1):
        for xx in range(xmin, xmax + 1):
            dx = xx - x
            dy = yy - y
            sq = int(dx * dx + dy * dy)  # int cast as s_orientation.cu:123
            if sq > sq_thres:
                continue
            grad, theta = _gradient(layer, xx, yy)
            weight = grad * math.exp(sq * factor)
            bidx = int(round(ORI_NBINS * (theta + math.pi) / (2 * math.pi)))
            if bidx == ORI_NBINS:
                bidx = 0
            hist[bidx] += weight

    # VLFeat smoothing: 3 iterations of two circular box-3 passes
    # (s_orientation.cu:142-156)
    for _ in range(3):
        for _ in range(2):
            hist = (np.roll(hist, 1) + hist + np.roll(hist, -1)) / 3.0

    # parabolic refinement per bin (s_orientation.cu:183-205)
    prev = np.roll(hist, 1)
    nxt = np.roll(hist, -1)
    peak = hist > np.maximum(prev, nxt)
    num = 3.0 * prev - 4.0 * hist + nxt
    denB = 2.0 * (prev - 2.0 * hist + nxt)
    denB = np.where(peak, denB, 1.0)
    newbin = num / denB
    ok = peak & (newbin >= 0.0) & (newbin <= 2.0)
    refined = np.where(ok, (np.arange(ORI_NBINS) - 1.0) % ORI_NBINS + newbin, -1.0)
    yval = np.where(ok, -(num * num) / (4.0 * denB) + prev, -np.inf)

    order = np.argsort(-yval)
    best = yval[order[0]]
    if not np.isfinite(best):
        return []
    out = []
    for i in order[:ORIENTATION_MAX_COUNT]:
        if yval[i] >= 0.8 * best and np.isfinite(yval[i]):
            chosen = refined[i]
            if chosen >= ORI_NBINS:
                chosen -= ORI_NBINS
            th = (2.0 * math.pi * chosen) / ORI_NBINS - math.pi
            out.append(th)
    return out


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

def _bilinear2d(img: np.ndarray, x: float, y: float) -> float:
    """Clamped 2-D bilinear sample (linear texture readTex semantics)."""
    H, W = img.shape
    x = min(max(x, 0.0), W - 1.0)
    y = min(max(y, 0.0), H - 1.0)
    x0, y0 = int(math.floor(x)), int(math.floor(y))
    x1, y1 = min(x0 + 1, W - 1), min(y0 + 1, H - 1)
    fx, fy = x - x0, y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def oracle_descriptor_grid(blur: np.ndarray, ext: OracleExtremum, ang: float,
                           config: SiftConfig) -> np.ndarray:
    """IGrid/NoTile descriptor: fixed 40x40 rotated sampling grid
    (s_desc_igrid.cu:19-108; constant tables sift_constants.cu:34-47).

    Samples positions p = kp + R(step)*SBP on the keypoint's blur level,
    gradient by rotated central differences through the linear texture,
    Gaussian envelope exp(-|u|^2/8), per-tile triangular weights, 8 soft
    angle bins. Returns the unnormalized 128-vector (tile-major: iy, ix,
    bin — matching dpt layout tile = ((iy*4+ix)*8)).
    """
    layer = blur[ext.level].astype(np.float64)
    x, y, sig = ext.x, ext.y, ext.sigma
    SBP = abs(DESC_MAGNIFY * sig)
    if SBP == 0:
        return np.zeros(128, F32)
    cos_t, sin_t = math.cos(ang), math.sin(ang)

    desc = np.zeros((4, 4, DESC_BINS + 1), dtype=np.float64)
    for iy in range(4):
        for ix in range(4):
            for yd in range(16):
                for xd in range(16):
                    stepx = ix - 2.5 + 1.0 / 16.0 + xd / 8.0
                    stepy = iy - 2.5 + 1.0 / 16.0 + yd / 8.0
                    ptx = cos_t * stepx - sin_t * stepy
                    pty = cos_t * stepy + sin_t * stepx
                    px = x + ptx * SBP
                    py = y + pty * SBP
                    dx = (_bilinear2d(layer, px + cos_t, py + sin_t)
                          - _bilinear2d(layer, px - cos_t, py - sin_t))
                    dy = (_bilinear2d(layer, px - sin_t, py + cos_t)
                          - _bilinear2d(layer, px + sin_t, py - cos_t))
                    mod = math.hypot(dx, dy)
                    th = math.atan2(dy, dx)
                    if th < 0:
                        th += 2 * math.pi
                    if th >= 2 * math.pi:
                        th -= 2 * math.pi
                    gx = ix * 8 + xd
                    gy = iy * 8 + yd
                    dnx = -2.5 + 1 / 16 + gx / 8.0
                    dny = -2.5 + 1 / 16 + gy / 8.0
                    ww = math.exp(-0.125 * (dnx * dnx + dny * dny))
                    wx = 1.0 - abs(-1.0 + 1.0 / 16.0 + xd / 8.0)
                    wy = 1.0 - abs(-1.0 + 1.0 / 16.0 + yd / 8.0)
                    wgt = ww * wx * wy * mod
                    tth = th * (4.0 / math.pi)
                    fo = int(math.floor(tth))
                    do0 = tth - fo
                    desc[iy, ix, (fo + 1) % 8] += wgt * do0
                    desc[iy, ix, fo % 8] += wgt * (1.0 - do0)
    return desc[:, :, :8].reshape(128).astype(F32)


def oracle_descriptor_tilegrid(blur: np.ndarray, ext: OracleExtremum,
                               ang: float, config: SiftConfig) -> np.ndarray:
    """True ``grid`` descriptor (s_desc_grid.cu:19-147): per tile a 16x16
    rotated grid, absolute sample addresses rounded to integer pixels
    (round half away from zero), axis-aligned integer-pixel gradients,
    weights recomputed from the rounded position; samples leaving their
    tile (w < 0) are skipped. Each sample feeds only its own tile."""
    layer = blur[ext.level].astype(np.float64)
    x, y, sig = ext.x, ext.y, ext.sigma
    SBP = abs(DESC_MAGNIFY * sig)
    if SBP == 0:
        return np.zeros(128, F32)
    cos_t, sin_t = math.cos(ang), math.sin(ang)

    desc = np.zeros((4, 4, DESC_BINS + 1), dtype=np.float64)
    for iy in range(4):
        for ix in range(4):
            offx, offy = ix - 1.5, iy - 1.5
            ptx = cos_t * SBP * offx - sin_t * SBP * offy + x
            pty = cos_t * SBP * offy + sin_t * SBP * offx + y
            for yd in range(16):
                for xd in range(16):
                    # lft_dn + (xd+.5)*rgt_stp + (yd+.5)*up_stp
                    pixox = (-cos_t + sin_t) + (xd + 0.5) * cos_t / 8.0 \
                        - (yd + 0.5) * sin_t / 8.0
                    pixoy = (-cos_t - sin_t) + (xd + 0.5) * sin_t / 8.0 \
                        + (yd + 0.5) * cos_t / 8.0
                    ax = ptx + pixox * SBP
                    ay = pty + pixoy * SBP
                    rx = math.copysign(math.floor(abs(ax) + 0.5), ax)
                    ry = math.copysign(math.floor(abs(ay) + 0.5), ay)
                    dx = (_bilinear2d(layer, rx + 1.0, ry)
                          - _bilinear2d(layer, rx - 1.0, ry))
                    dy = (_bilinear2d(layer, rx, ry + 1.0)
                          - _bilinear2d(layer, rx, ry - 1.0))
                    mod = math.hypot(dx, dy)
                    th = math.atan2(dy, dx)
                    pxo = (rx - ptx) / SBP
                    pyo = (ry - pty) / SBP
                    nx = cos_t * pxo + sin_t * pyo
                    ny = cos_t * pyo - sin_t * pxo
                    wx = 1.0 - abs(nx)
                    wy = 1.0 - abs(ny)
                    if wx < 0.0 or wy < 0.0:
                        continue
                    dnx = nx + offx
                    dny = ny + offy
                    ww = math.exp(-0.125 * (dnx * dnx + dny * dny))
                    wgt = ww * wx * wy * mod
                    th -= ang
                    while th < 0:
                        th += 2 * math.pi
                    while th >= 2 * math.pi:
                        th -= 2 * math.pi
                    tth = th * (4.0 / math.pi)
                    fo0 = int(math.floor(tth))
                    do0 = tth - fo0
                    fo = fo0 % DESC_BINS
                    desc[iy, ix, fo] += (1.0 - do0) * wgt
                    desc[iy, ix, fo + 1] += do0 * wgt
    desc[:, :, 0] += desc[:, :, 8]
    return desc[:, :, :8].reshape(128).astype(F32)


def oracle_descriptor_iloop(blur: np.ndarray, ext: OracleExtremum,
                            ang: float, config: SiftConfig) -> np.ndarray:
    """``iloop`` descriptor (s_desc_iloop.cu:19-153): per tile, a 32x32
    axis-aligned sample grid over the rotated tile bbox (half-width
    |cos|+|sin| SBP units); rotated-offset bilinear gradients, theta
    already in the rotated frame (no ``th -= ang``)."""
    layer = blur[ext.level].astype(np.float64)
    x, y, sig = ext.x, ext.y, ext.sigma
    SBP = abs(DESC_MAGNIFY * sig)
    if SBP == 0:
        return np.zeros(128, F32)
    cos_t, sin_t = math.cos(ang), math.sin(ang)
    bsz = abs(cos_t) + abs(sin_t)

    desc = np.zeros((4, 4, DESC_BINS + 1), dtype=np.float64)
    for iy in range(4):
        for ix in range(4):
            offx, offy = ix - 1.5, iy - 1.5
            ptx = cos_t * SBP * offx - sin_t * SBP * offy
            pty = cos_t * SBP * offy + sin_t * SBP * offx
            for i in range(32):
                dy_ = -bsz + i * bsz / 16.0
                for j in range(32):
                    dx_ = -bsz + j * bsz / 16.0
                    nx = cos_t * dx_ + sin_t * dy_
                    ny = cos_t * dy_ - sin_t * dx_
                    if abs(nx) >= 1.0 or abs(ny) >= 1.0:
                        continue
                    px = x + ptx + dx_ * SBP
                    py = y + pty + dy_ * SBP
                    gdx = (_bilinear2d(layer, px + cos_t, py + sin_t)
                           - _bilinear2d(layer, px - cos_t, py - sin_t))
                    gdy = (_bilinear2d(layer, px - sin_t, py + cos_t)
                           - _bilinear2d(layer, px + sin_t, py - cos_t))
                    mod = math.hypot(gdx, gdy)
                    th = math.atan2(gdy, gdx)
                    if th < 0:
                        th += 2 * math.pi
                    if th >= 2 * math.pi:
                        th -= 2 * math.pi
                    dnx = nx + offx
                    dny = ny + offy
                    ww = math.exp(-0.125 * (dnx * dnx + dny * dny))
                    wgt = ww * (1.0 - abs(nx)) * (1.0 - abs(ny)) * mod
                    tth = th * (4.0 / math.pi)
                    fo0 = int(math.floor(tth))
                    do0 = tth - fo0
                    fo = fo0 % DESC_BINS
                    desc[iy, ix, fo] += (1.0 - do0) * wgt
                    desc[iy, ix, fo + 1] += do0 * wgt
    desc[:, :, 0] += desc[:, :, 8]
    return desc[:, :, :8].reshape(128).astype(F32)


def oracle_descriptor_loop(blur: np.ndarray, ext: OracleExtremum, ang: float,
                           config: SiftConfig) -> np.ndarray:
    """Loop descriptor: per-tile pixel scan (s_desc_loop.cu:19-138).

    For each of the 16 tiles, scans the axis-aligned bbox of the rotated
    tile window, trilinear weights from rotated unit coordinates, gradient
    at integer pixels.
    """
    layer = blur[ext.level].astype(np.float64)
    H, W = layer.shape
    x, y, sig = ext.x, ext.y, ext.sigma
    SBP = abs(DESC_MAGNIFY * sig)
    if SBP == 0:
        return np.zeros(128, F32)
    cos_t, sin_t = math.cos(ang), math.sin(ang)
    csbp, ssbp = cos_t * SBP, sin_t * SBP
    crsbp, srsbp = cos_t / SBP, sin_t / SBP

    desc = np.zeros((4, 4, DESC_BINS + 1), dtype=np.float64)
    for iy in range(4):
        for ix in range(4):
            offx, offy = ix - 1.5, iy - 1.5
            ptx = csbp * offx - ssbp * offy + x
            pty = csbp * offy + ssbp * offx + y
            bsz = abs(csbp) + abs(ssbp)
            xmin = max(1, int(math.floor(ptx - bsz)))
            ymin = max(1, int(math.floor(pty - bsz)))
            xmax = min(W - 2, int(math.floor(ptx + bsz)))
            ymax = min(H - 2, int(math.floor(pty + bsz)))
            for ii in range(ymin, ymax + 1):
                for jj in range(xmin, xmax + 1):
                    dxp = jj - ptx
                    dyp = ii - pty
                    nx = crsbp * dxp + srsbp * dyp
                    ny = crsbp * dyp - srsbp * dxp
                    if abs(nx) >= 1.0 or abs(ny) >= 1.0:
                        continue
                    mod, th = _gradient(layer, jj, ii)
                    dnx = nx + offx
                    dny = ny + offy
                    ww = math.exp(-0.125 * (dnx * dnx + dny * dny))
                    wgt = ww * (1.0 - abs(nx)) * (1.0 - abs(ny)) * mod
                    th -= ang
                    while th < 0:
                        th += 2 * math.pi
                    while th >= 2 * math.pi:
                        th -= 2 * math.pi
                    tth = th * (4.0 / math.pi)
                    fo0 = int(math.floor(tth))
                    do0 = tth - fo0
                    fo = fo0 % DESC_BINS
                    desc[iy, ix, fo] += (1.0 - do0) * wgt
                    desc[iy, ix, fo + 1] += do0 * wgt
    desc[:, :, 0] += desc[:, :, 8]
    return desc[:, :, :8].reshape(128).astype(F32)


def normalize_descriptor(desc: np.ndarray, config: SiftConfig) -> np.ndarray:
    """RootSift (s_desc_norm_rs.h:44-80) or classic L2 (s_desc_norm_l2.h)."""
    desc = desc.astype(np.float64)
    mult = 2.0 ** config.norm_multiplier
    if config.norm_mode == "rootsift":
        s = desc.sum()
        if s == 0:
            return desc.astype(F32)
        return (np.sqrt(desc / s) * mult).astype(F32)
    # classic: L2 normalize, clamp at 0.2, renormalize (Lowe)
    n = math.sqrt((desc * desc).sum())
    if n == 0:
        return desc.astype(F32)
    desc = np.minimum(desc, 0.2 * n)
    n2 = math.sqrt((desc * desc).sum())
    return (desc * (mult / n2)).astype(F32)


# ---------------------------------------------------------------------------
# End-to-end
# ---------------------------------------------------------------------------

def oracle_extract(img_u8: np.ndarray, config: SiftConfig,
                   desc_variant: str = "grid"):
    """Full extraction. Returns a list of OracleExtremum with positions in
    *input image* coordinates (prep_features scaling by 2^(octave - up),
    sift_pyramid.cu:250-261) and normalized descriptors attached."""
    blurs, dogs = oracle_pyramid(img_u8, config)
    up = config.upscale_factor
    feats = []
    for octv, (blur, dog) in enumerate(zip(blurs, dogs)):
        exts = oracle_extrema(dog, config, octv)
        for e in exts:
            angs = oracle_orientations(blur, e, config)
            if not angs:
                continue
            e.orientations = angs
            for ang in angs:
                # variant names map 1:1 onto the reference DescModes;
                # "igrid"/"notile" share the 40x40 formulation (see
                # oracle_descriptor_grid docstring)
                if desc_variant in ("grid-igrid", "igrid", "notile"):
                    d = oracle_descriptor_grid(blur, e, ang, config)
                elif desc_variant == "grid":
                    d = oracle_descriptor_tilegrid(blur, e, ang, config)
                elif desc_variant == "iloop":
                    d = oracle_descriptor_iloop(blur, e, ang, config)
                else:
                    d = oracle_descriptor_loop(blur, e, ang, config)
                e.descriptors.append(normalize_descriptor(d, config))
            scale = 2.0 ** (octv - up)
            feats.append(OracleExtremum(
                octave=octv, x=e.x * scale, y=e.y * scale, s=e.s,
                level=e.level, sigma=e.sigma * scale, cell=e.cell,
                orientations=e.orientations, descriptors=e.descriptors))
    return feats
