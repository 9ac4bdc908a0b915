"""The numbers that decide ``correct``: how far the program's features
lie from the reference's.

Keypoints are paired within an octave by mutual nearest neighbours in
octave coordinates (x and y in octave pixels, the level coordinate
s = levels * log2(sigma / sigma0)), within ``PAIR_TOL``. A keypoint of
either side without a partner is missed. Descriptors of paired
keypoints pair slot by slot where their orientations agree within
``ANGLE_TOL`` radians and no entry differs by more than ``DESC_TOL``;
a descriptor of either side without a partner is missed. The numbers
compared are the shares (%) missed. Matches and inliers of a pair pair
up through the descriptor pairing; a match or inlier of either side
without the same pair on the other is missed.
"""

from __future__ import annotations

import math

import numpy as np

PAIR_TOL = 0.05          # octave pixels (and levels)
ANGLE_TOL = 0.01         # radians
DESC_TOL = 0.02          # RootSift entries (each in [0, 1])


def _octave_coords(f: dict, p) -> np.ndarray:
    scale = np.exp2(f["octave"].astype(np.float64) - p.upscale_factor)
    s = p.levels * np.log2(f["sigma"].astype(np.float64) / scale / p.sigma)
    return np.stack([f["x"] / scale, f["y"] / scale, s], 1)


def pair_keypoints(got: dict, ref: dict, p):
    """(i_got, i_ref, gaps): the paired keypoint rows and their distances
    in octave coordinates."""
    cg, cr = _octave_coords(got, p), _octave_coords(ref, p)
    gi, ri, gaps = [], [], []
    for o in np.union1d(np.unique(got["octave"]), np.unique(ref["octave"])):
        a = np.nonzero(got["octave"] == o)[0]
        b = np.nonzero(ref["octave"] == o)[0]
        if not len(a) or not len(b):
            continue
        d = np.sqrt(((cg[a, None, :] - cr[None, b, :]) ** 2).sum(-1))
        j = d.argmin(1)
        mutual = d.argmin(0)[j] == np.arange(len(a))
        dist = d[np.arange(len(a)), j]
        ok = mutual & (dist <= PAIR_TOL)
        gi.append(a[ok])
        ri.append(b[j[ok]])
        gaps.append(dist[ok])
    cat = lambda xs, t: np.concatenate(xs).astype(t) if xs else np.zeros(0, t)
    return cat(gi, np.int64), cat(ri, np.int64), cat(gaps, np.float64)


def pair_descriptors(got: dict, ref: dict, gi, ri):
    """(d_got, d_ref): descriptor rows paired through paired keypoints,
    slot by slot where the orientations agree."""
    def rows_by_kp(f):
        order = np.argsort(f["desc_to_kp"], kind="stable")
        kp = f["desc_to_kp"][order]
        first = np.searchsorted(kp, np.arange(len(f["x"]) + 1))
        return order, first

    og, fg = rows_by_kp(got)
    orr, fr = rows_by_kp(ref)
    dg, dr = [], []
    for slot in range(4):
        has = (fg[gi + 1] - fg[gi] > slot) & (fr[ri + 1] - fr[ri] > slot)
        a, b = gi[has], ri[has]
        ang_g = got["orientations"][a, slot].astype(np.float64)
        ang_r = ref["orientations"][b, slot].astype(np.float64)
        gap = np.abs(np.angle(np.exp(1j * (ang_g - ang_r))))
        ok = gap <= ANGLE_TOL
        dg.append(og[fg[a[ok]] + slot])
        dr.append(orr[fr[b[ok]] + slot])
    return np.concatenate(dg), np.concatenate(dr)


def _miss_pct(n_pairs: int, n_a: int, n_b: int) -> float:
    total = n_a + n_b
    return 100.0 * (total - 2 * n_pairs) / total if total else 0.0


def feature_numbers(got: dict, ref: dict, p) -> tuple:
    """({kp_miss_pct, desc_miss_pct}, {kp_gap, desc_gap}, descriptor
    pairing (d_got, d_ref)): the numbers compared, the widest gaps of the
    pairs (for the record), and the pairing."""
    gi, ri, gaps = pair_keypoints(got, ref, p)
    dg, dr = pair_descriptors(got, ref, gi, ri)
    row_gap = np.abs(got["descriptors"][dg].astype(np.float64)
                     - ref["descriptors"][dr]).max(1) if len(dg) \
        else np.zeros(0)
    close = row_gap <= DESC_TOL
    dg, dr = dg[close], dr[close]
    nums = {"kp_miss_pct": _miss_pct(len(gi), len(got["x"]), len(ref["x"])),
            "desc_miss_pct": _miss_pct(len(dg), len(got["descriptors"]),
                                       len(ref["descriptors"]))}
    info = {"kp_gap": float(gaps.max()) if len(gaps) else math.nan,
            "desc_gap": float(row_gap[close].max()) if close.any()
            else math.nan}
    return nums, info, (dg, dr)


def pairs_miss_pct(got_pairs: np.ndarray, ref_pairs: np.ndarray,
                   left: tuple, right: tuple) -> float:
    """Share (%) of (left descriptor, right descriptor) pairs, on either
    side, without the same pair on the other; ``left`` and ``right`` are
    the descriptor pairings (d_got, d_ref) of the two frames."""
    def mapped(pairs, pairing_l, pairing_r):
        ml = dict(zip(pairing_l[0].tolist(), pairing_l[1].tolist()))
        mr = dict(zip(pairing_r[0].tolist(), pairing_r[1].tolist()))
        return {(ml.get(a, -1 - i), mr.get(b, -1 - i))
                for i, (a, b) in enumerate(pairs.tolist())}

    g = mapped(got_pairs, left, right)
    r = {tuple(x) for x in ref_pairs.tolist()}
    both = len(g & r)
    return _miss_pct(both, len(got_pairs), len(ref_pairs))
