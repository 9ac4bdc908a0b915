"""Plain PyTorch SIFT extraction: the benchmark's reference.

The semantics of the scalar NumPy oracle (``popsift_tpu_torch/oracle/
sift_oracle.py``, which cites the PopSift source line by line) written
as tensor operations, so that a 1080p frame takes seconds on the card
instead of hours in Python loops. Each octave keeps its candidates in
ascending flat (level, row, column) order, at most the source's
``max_extrema`` an octave (s_extrema.cu:551-561). The program's static
capacities and its compaction's block clamp are not modelled: where a
configuration's capacity is too small for a frame, the program drops
candidates that the reference keeps, and the comparison counts them as
missed.

Precision: the pyramid is computed in ``dtype`` (float64 normally) and
stored in float32, the refinement is float32 as the reference's solver
is, the orientation histograms and descriptors float64 from the stored
planes. ``dtype=torch.bfloat16`` computes and stores the pyramid, the
gradient planes and the descriptors in bfloat16: the control that a
correct run must tell apart from the program.

It imports nothing of the program: every table and size comes from
``gauss.py`` beside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .gauss import Params, filter_tables

NBINS = 36
MAX_ORI = 4
MAX_ITERATIONS = 5


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------

def _conv_half(img: torch.Tensor, half: np.ndarray, span: int,
               dim: int) -> torch.Tensor:
    """Symmetric filter of half-taps ``half[:span]`` along ``dim`` with
    edge replication (readTex clamps, s_pyramid_build_aa.cu:31-48)."""
    n = img.shape[dim]
    pad = span - 1
    idx = torch.arange(-pad, n + pad, device=img.device).clamp(0, n - 1)
    padded = img.index_select(dim, idx)
    part = lambda a: padded.narrow(dim, a, n)
    out = part(pad) * float(half[0])
    for off in range(1, span):
        out = out + (part(pad - off) + part(pad + off)) * float(half[off])
    return out


def _octave0(img: torch.Tensor, oh: int, ow: int, shift: float, dd0, dd0_span,
             inc0, inc0_span, dtype) -> torch.Tensor:
    """Octave 0 level 0 from the input (s_pyramid_build_ra.cu:18-55, then
    s_pyramid_build_aa.cu:56-92): bilinear samples of the input at
    (i + shift) * src/dst - 0.5, taps one destination pixel apart, times
    255, then the vertical pass."""
    sh, sw = img.shape
    dev = img.device
    ys = ((torch.arange(oh, dtype=torch.float64, device=dev) + shift)
          * (sh / oh) - 0.5).clamp(0.0, sh - 1.0)
    y0 = ys.floor().long()
    y1 = (y0 + 1).clamp(max=sh - 1)
    fy = (ys - y0).to(dtype)[:, None]
    rows = img[y0] * (1.0 - fy) + img[y1] * fy             # [oh, sw]
    rx = sw / ow
    base = (torch.arange(ow, dtype=torch.float64, device=dev) + shift) * rx \
        - 0.5

    def sample(px):
        px = px.clamp(0.0, sw - 1.0)
        x0 = px.floor().long()
        x1 = (x0 + 1).clamp(max=sw - 1)
        f = (px - x0).to(dtype)
        return rows[:, x0] * (1.0 - f) + rows[:, x1] * f

    out = sample(base) * float(dd0[0])
    for off in range(1, dd0_span):
        out = out + (sample(base - off * rx) + sample(base + off * rx)) \
            * float(dd0[off])
    return _conv_half(out * 255.0, inc0, inc0_span, 0)


def pyramid(img_u8: torch.Tensor, p: Params, dtype=torch.float64):
    """Blur and DoG stacks of every octave: lists of [L, H, W] and
    [L-1, H, W] in float32 (bfloat16 when ``dtype`` is), the default
    build of build_pyramid (s_pyramid_build.cu:546-596)."""
    t = filter_tables(p)
    store = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    img = img_u8.to(dtype) / 255.0
    dims = p.octave_dims(img.shape[1], img.shape[0])
    shift0 = 0.5 * 2.0 ** p.upscale_factor
    L = p.total_levels
    blurs, dogs = [], []
    for o, (oh, ow) in enumerate(dims):
        if o == 0:
            lv = _octave0(img, oh, ow, shift0, t["dd0"], t["dd0_span"],
                          t["inc"][0], t["inc_span"][0], dtype)
        else:
            lv = blurs[-1][L - 3][0::2, 0::2][:oh, :ow].to(dtype)
        levels = [lv]
        for lvl in range(1, L):
            tmp = _conv_half(levels[-1], t["inc"][lvl], t["inc_span"][lvl], 1)
            levels.append(_conv_half(tmp, t["inc"][lvl], t["inc_span"][lvl],
                                     0))
        stack = torch.stack(levels)
        blurs.append(stack.to(store))
        dogs.append((stack[1:] - stack[:-1]).to(store))
    return blurs, dogs


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def candidate_mask(dog: torch.Tensor, p: Params) -> torch.Tensor:
    """bool[Z, H, W] of layers 1..Z: |v| at least 1.6 x the threshold and
    strictly above or below all 26 neighbours (s_extrema.cu:56-120,
    253-256); border pixels are never candidates."""
    Z = p.total_levels - 3
    D, H, W = dog.shape
    thr1 = float(np.float32(1.6 * p.peak_threshold))
    c = dog[1:Z + 1, 1:H - 1, 1:W - 1]
    above = torch.ones_like(c, dtype=torch.bool)
    below = torch.ones_like(c, dtype=torch.bool)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == dy == dx == 0:
                    continue
                n = dog[1 + dz:Z + 1 + dz, 1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx]
                above &= c > n
                below &= c < n
    mask = torch.zeros((Z, H, W), dtype=torch.bool, device=dog.device)
    mask[:, 1:H - 1, 1:W - 1] = (c.abs() >= thr1) & (above | below)
    return mask


def compact(mask: torch.Tensor, limit: int):
    """(z, y, x) i64 of the candidates of one octave's mask, in ascending
    flat order, at most ``limit``."""
    Z, H, W = mask.shape
    idx = torch.nonzero(mask.reshape(-1))[:, 0][:limit]
    return idx // (H * W) + 1, (idx % (H * W)) // W, idx % W


def _solve3(A, b):
    """Batched symmetric 3x3 solve by the adjugate in float32
    (s_solve.h:24-85); ok is False where det == 0 exactly."""
    a00, a01, a02 = A[0][0], A[0][1], A[0][2]
    a11, a12, a22 = A[1][1], A[1][2], A[2][2]
    det0 = a11 * a22 - a12 * a12
    det1 = a12 * a02 - a01 * a22
    det2 = a01 * a12 - a11 * a02
    det3 = a00 * a22 - a02 * a02
    det4 = a01 * a02 - a00 * a12
    det5 = a00 * a11 - a01 * a01
    det = a00 * det0 + a01 * det1 + a02 * det2
    ok = det != 0.0
    rsd = 1.0 / torch.where(ok, det, torch.ones_like(det))
    inv = [[det0, det1, det2], [det1, det3, det4], [det2, det4, det5]]
    x = [(inv[i][0] * rsd) * b[0] + (inv[i][1] * rsd) * b[1]
         + (inv[i][2] * rsd) * b[2] for i in range(3)]
    return ok, x


def refine(dog: torch.Tensor, z0, y0, x0, p: Params):
    """The quadratic refinement loop and its accept tests
    (s_extrema.cu:258-297, 359-503), float32, for one octave's candidates.
    Returns (keep bool[N], x, y, s as float64 octave coordinates)."""
    D, H, W = dog.shape
    dog = dog.float()
    maxlevel = p.total_levels - 1
    n = torch.stack([x0, y0, z0])                           # [3, N]
    N = n.shape[1]
    dev = dog.device

    def rd(dx, dy, dz):
        return dog[(n[2] + dz).clamp(0, D - 1), (n[1] + dy).clamp(0, H - 1),
                   (n[0] + dx).clamp(0, W - 1)]

    v = rd(0, 0, 0)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    d = [torch.zeros(N, device=dev) for _ in range(3)]
    Dv = [torch.zeros(N, device=dev) for _ in range(3)]
    DD = [torch.zeros(N, device=dev) for _ in range(3)]
    DX = [torch.zeros(N, device=dev) for _ in range(3)]
    upper = torch.tensor([W - 2, H - 2, maxlevel - 1], device=dev)[:, None]
    for it in range(1, MAX_ITERATIONS + 1):
        c = rd(0, 0, 0)
        nD = [0.5 * (rd(1, 0, 0) - rd(-1, 0, 0)),
              0.5 * (rd(0, 1, 0) - rd(0, -1, 0)),
              0.5 * (rd(0, 0, 1) - rd(0, 0, -1))]
        nDD = [rd(1, 0, 0) + rd(-1, 0, 0) - 2 * c,
               rd(0, 1, 0) + rd(0, -1, 0) - 2 * c,
               rd(0, 0, 1) + rd(0, 0, -1) - 2 * c]
        nDX = [0.25 * (rd(1, 1, 0) + rd(-1, -1, 0) - rd(-1, 1, 0)
                       - rd(1, -1, 0)),
               0.25 * (rd(1, 0, 1) + rd(-1, 0, -1) - rd(-1, 0, 1)
                       - rd(1, 0, -1)),
               0.25 * (rd(0, 1, 1) + rd(0, -1, -1) - rd(0, 1, -1)
                       - rd(0, -1, 1))]
        A = [[nDD[0], nDX[0], nDX[1]], [nDX[0], nDD[1], nDX[2]],
             [nDX[1], nDX[2], nDD[2]]]
        ok, sol = _solve3(A, [-nD[0], -nD[1], -nD[2]])
        for arr, new in ((Dv, nD), (DD, nDD), (DX, nDX)):
            for i in range(3):
                arr[i] = torch.where(active, new[i], arr[i])
        for i in range(3):
            d[i] = torch.where(active, torch.where(ok, sol[i], 0.0), d[i])
        active = active & ok
        if it == MAX_ITERATIONS:
            break
        dd = torch.stack(d)
        step = ((dd >= 0.6) & (n < upper)).long() \
            - ((dd <= -0.6) & (n > 1)).long()
        moved = (step != 0).any(0)
        n = torch.where(active & moved, n + step, n)
        active = active & moved
    dd = torch.stack(d)
    keep = ~(dd >= 1.5).any(0)
    x = n[0].double() + d[0].double()
    y = n[1].double() + d[1].double()
    s = n[2].double() + d[2].double()
    keep &= (x >= 0) & (x <= W - 1.0) & (y >= 0) & (y <= H - 1.0) \
        & (s >= 0) & (s <= maxlevel)
    contr = v + 0.5 * (Dv[0] * d[0] + Dv[1] * d[1] + Dv[2] * d[2])
    tr = (DD[0] + DD[1]).double()
    det = (DD[0] * DD[1] - DX[0] * DX[0]).double()
    thr = float(np.float32(p.peak_threshold))
    e = p.edge_limit
    keep &= (det > 0) & (contr.abs() >= 2.0 * thr) \
        & (tr * tr / det.clamp(min=1e-300) < (e + 1.0) ** 2 / e)
    return keep, x, y, s


# ---------------------------------------------------------------------------
# orientation and descriptors
# ---------------------------------------------------------------------------

class _Gradients:
    """Gradient magnitude and angle planes of each (octave, level) used,
    central differences with clamped reads (s_gradiant.h:55-69), made
    on first use."""

    def __init__(self, blurs, dtype):
        self.blurs, self.dtype, self.planes = blurs, dtype, {}

    def __call__(self, o: int, lvl: int):
        key = (o, lvl)
        if key not in self.planes:
            b = self.blurs[o][lvl]
            b = b.to(torch.float64 if self.dtype == torch.float64 else b.dtype)
            H, W = b.shape
            xi = torch.arange(W, device=b.device)
            yi = torch.arange(H, device=b.device)
            dx = b[:, (xi + 1).clamp(max=W - 1)] - b[:, (xi - 1).clamp(min=0)]
            dy = b[(yi + 1).clamp(max=H - 1)] - b[(yi - 1).clamp(min=0)]
            self.planes[key] = (torch.hypot(dx, dy), torch.atan2(dy, dx))
        return self.planes[key]


def _chunks(sizes: torch.Tensor, budget: int):
    """Index chunks of items ordered by ``sizes``, each chunk's items
    times its largest window, (2 size + 1)^2, under ``budget``."""
    order = torch.argsort(sizes)
    out, start = [], 0
    s = sizes[order].tolist()
    for i in range(1, len(s) + 1):
        if i == len(s) or (i - start + 1) * (2 * s[i] + 1) ** 2 > budget:
            out.append(order[start:i])
            start = i
    return out


def orientations(grad: _Gradients, o: int, x, y, sigma, level, H: int,
                 W: int):
    """Up to four orientations of each keypoint, largest peak first
    (ori_par, s_orientation.cu:60-242, with VLFeat smoothing): (angles
    float64 [K, 4], valid bool [K, 4])."""
    K = x.shape[0]
    dev = x.device
    sigw = 1.5 * sigma
    rad = torch.round(3.0 * sigw).long()
    factor = -0.5 / (sigw * sigw)
    hist = torch.zeros((K, NBINS), dtype=torch.float64, device=dev)
    xr, yr = torch.round(x).long(), torch.round(y).long()
    for lvl in torch.unique(level).tolist():
        mod, th = grad(o, lvl)
        for idx in _chunks(torch.where(level == lvl, rad, -1), 1 << 24):
            idx = idx[level[idx] == lvl]
            if idx.numel() == 0:
                continue
            R = int(rad[idx].max())
            off = torch.arange(-R, R + 1, device=dev)
            xx = xr[idx, None, None] + off[None, None, :]
            yy = yr[idx, None, None] + off[None, :, None]
            r = rad[idx, None, None]
            inside = (xx >= (xr[idx, None, None] - r).clamp(min=1)) \
                & (xx <= (xr[idx, None, None] + r).clamp(max=W - 2)) \
                & (yy >= (yr[idx, None, None] - r).clamp(min=1)) \
                & (yy <= (yr[idx, None, None] + r).clamp(max=H - 2))
            ddx = xx - x[idx, None, None]
            ddy = yy - y[idx, None, None]
            sq = torch.trunc(ddx * ddx + ddy * ddy)
            inside &= sq <= (r * r)
            xc, yc = xx.clamp(0, W - 1), yy.clamp(0, H - 1)
            g = mod[yc, xc].double()
            t = th[yc, xc].double()
            w = g * torch.exp(sq * factor[idx, None, None])
            b = torch.round(NBINS * (t + math.pi) / (2 * math.pi)).long()
            b = torch.where(b == NBINS, 0, b)
            w = torch.where(inside, w, 0.0)
            hist[idx] = hist[idx].scatter_add(1, b.reshape(len(idx), -1),
                                              w.reshape(len(idx), -1))
    for _ in range(6):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    prev, nxt = torch.roll(hist, 1, 1), torch.roll(hist, -1, 1)
    peak = hist > torch.maximum(prev, nxt)
    num = 3.0 * prev - 4.0 * hist + nxt
    den = torch.where(peak, 2.0 * (prev - 2.0 * hist + nxt), 1.0)
    newbin = num / den
    ok = peak & (newbin >= 0.0) & (newbin <= 2.0)
    bins = torch.arange(NBINS, device=dev, dtype=torch.float64)
    refined = torch.where(ok, (bins - 1.0) % NBINS + newbin, -1.0)
    yval = torch.where(ok, -(num * num) / (4.0 * den) + prev, -math.inf)
    top, order = torch.sort(yval, dim=1, descending=True, stable=True)
    top, order = top[:, :MAX_ORI], order[:, :MAX_ORI]
    valid = torch.isfinite(top) & (top >= 0.8 * top[:, :1])
    chosen = refined.gather(1, order)
    chosen = torch.where(chosen >= NBINS, chosen - NBINS, chosen)
    ang = 2.0 * math.pi * chosen / NBINS - math.pi
    return torch.where(valid, ang, 0.0), valid


def descriptors(grad: _Gradients, o: int, x, y, sigma, level, ang, H: int,
                W: int, dtype):
    """The ``loop`` descriptor of each job (s_desc_loop.cu:19-138): per
    tile the pixels of its rotated window, trilinear weights, 8 angle
    bins; float64 ([J, 128]), bfloat16 sums for the control."""
    J = x.shape[0]
    dev = x.device
    acc = torch.float64 if dtype == torch.float64 else dtype
    out = torch.zeros((J, 4, 4, 9), dtype=acc, device=dev)
    sbp = (3.0 * sigma).abs()
    c, s = torch.cos(ang), torch.sin(ang)
    csbp, ssbp = c * sbp, s * sbp
    crsbp, srsbp = c / sbp, s / sbp
    bsz = csbp.abs() + ssbp.abs()
    reach = torch.ceil(2.5 * bsz).long() + 2
    xr, yr = torch.floor(x).long(), torch.floor(y).long()
    offs = torch.arange(4, device=dev, dtype=torch.float64) - 1.5
    for lvl in torch.unique(level).tolist():
        mod, th = grad(o, lvl)
        for idx in _chunks(torch.where(level == lvl, reach, -1), 1 << 23):
            idx = idx[level[idx] == lvl]
            if idx.numel() == 0:
                continue
            R = int(reach[idx].max())
            off = torch.arange(-R, R + 1, device=dev)
            jj = (xr[idx, None, None] + off[None, None, :]).expand(
                -1, 2 * R + 1, -1)
            ii = (yr[idx, None, None] + off[None, :, None]).expand(
                -1, -1, 2 * R + 1)
            jj, ii = jj.reshape(len(idx), -1), ii.reshape(len(idx), -1)
            live = (jj >= 1) & (jj <= W - 2) & (ii >= 1) & (ii <= H - 2)
            g = mod[ii.clamp(0, H - 1), jj.clamp(0, W - 1)].to(acc)
            t = th[ii.clamp(0, H - 1), jj.clamp(0, W - 1)].to(acc)
            a = ang[idx, None].to(acc)
            t = t - a
            t = torch.where(t < 0, t + 2 * math.pi, t)
            t = torch.where(t < 0, t + 2 * math.pi, t)
            t = torch.where(t >= 2 * math.pi, t - 2 * math.pi, t)
            tth = t * (4.0 / math.pi)
            fo0 = torch.floor(tth)
            do0 = tth - fo0
            fo = fo0.long() % 8
            jjd, iid = jj.double(), ii.double()
            for iy in range(4):
                for ix in range(4):
                    ptx = csbp[idx, None] * offs[ix] - ssbp[idx, None] \
                        * offs[iy] + x[idx, None]
                    pty = csbp[idx, None] * offs[iy] + ssbp[idx, None] \
                        * offs[ix] + y[idx, None]
                    b = bsz[idx, None]
                    inbox = (jj >= torch.floor(ptx - b)) \
                        & (jj <= torch.floor(ptx + b)) \
                        & (ii >= torch.floor(pty - b)) \
                        & (ii <= torch.floor(pty + b))
                    dxp, dyp = jjd - ptx, iid - pty
                    nx = crsbp[idx, None] * dxp + srsbp[idx, None] * dyp
                    ny = crsbp[idx, None] * dyp - srsbp[idx, None] * dxp
                    use = live & inbox & (nx.abs() < 1.0) & (ny.abs() < 1.0)
                    dnx, dny = nx + offs[ix], ny + offs[iy]
                    ww = torch.exp(-0.125 * (dnx * dnx + dny * dny))
                    wgt = (ww * (1.0 - nx.abs()) * (1.0 - ny.abs())).to(acc) \
                        * g
                    wgt = torch.where(use, wgt, 0.0)
                    cell = out[idx, iy, ix]
                    cell = cell.scatter_add(1, fo, (1.0 - do0) * wgt)
                    cell = cell.scatter_add(1, fo + 1, do0 * wgt)
                    out[idx, iy, ix] = cell
    out[..., 0] += out[..., 8]
    return out[..., :8].reshape(J, 128)


def normalize(desc: torch.Tensor, p: Params) -> torch.Tensor:
    """RootSift (s_desc_norm_rs.h:44-80) times 2^norm_multiplier."""
    mult = 2.0 ** p.norm_multiplier
    total = desc.sum(1, keepdim=True)
    return torch.where(total > 0, torch.sqrt(desc / total.clamp(min=1e-300))
                       * mult, desc)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def extract(img_u8: torch.Tensor, p: Params, dtype=torch.float64) -> dict:
    """Features of one [H, W] uint8 frame on its device, as numpy arrays in
    the layout of the program's host result: keypoints with at least one
    orientation (``x``, ``y``, ``sigma`` in input pixels, ``octave``,
    ``orientations`` [K, 4], ``ori_valid``), ``descriptors`` [D, 128] in
    (octave, candidate, orientation) order and ``desc_to_kp``; plus
    ``candidates``, the kept candidates of each octave, ``refined_sigma``,
    the octave-relative scale of every refined keypoint (with or without
    an orientation), and ``job_sigma``, each descriptor's."""
    blurs, dogs = pyramid(img_u8, p, dtype)
    grad = _Gradients(blurs, dtype)
    dims = p.octave_dims(img_u8.shape[1], img_u8.shape[0])
    parts = {k: [] for k in ("x", "y", "sigma", "octave", "orientations",
                             "ori_valid", "descriptors", "desc_to_kp",
                             "job_sigma", "refined_sigma")}
    n_kp = 0
    cands = []
    for o, ((H, W), dog) in enumerate(zip(dims, dogs)):
        z0, y0, x0 = compact(candidate_mask(dog, p), p.max_extrema)
        cands.append(int(z0.numel()))
        keep, x, y, s = refine(dog, z0, y0, x0, p)
        x, y, s = x[keep], y[keep], s[keep]
        sigma = p.sigma * p.sigma_k ** s
        level = torch.round(s).long()
        ang, ov = orientations(grad, o, x, y, sigma, level, H, W)
        parts["refined_sigma"].append(sigma)
        has = ov.any(1)
        x, y, s, sigma, level, ang, ov = (a[has] for a in (
            x, y, s, sigma, level, ang, ov))
        kp, slot = torch.nonzero(ov, as_tuple=True)   # (kp, slot) ascending
        desc = descriptors(grad, o, x[kp], y[kp], sigma[kp], level[kp],
                           ang[kp, slot], H, W, dtype)
        scale = 2.0 ** (o - p.upscale_factor)
        parts["x"].append(x * scale)
        parts["y"].append(y * scale)
        parts["sigma"].append(sigma * scale)
        parts["octave"].append(torch.full((x.shape[0],), o,
                                          dtype=torch.int64, device=x.device))
        parts["orientations"].append(ang)
        parts["ori_valid"].append(ov)
        parts["descriptors"].append(normalize(desc.double(), p))
        parts["desc_to_kp"].append(kp + n_kp)
        parts["job_sigma"].append(sigma[kp])
        n_kp += x.shape[0]
    out = {k: torch.cat(v).cpu().numpy() for k, v in parts.items()}
    out["candidates"] = np.asarray(cands, np.int64)
    return out
