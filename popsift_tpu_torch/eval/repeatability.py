"""Keypoint repeatability and matching score under a known homography.

The port's own copy of :mod:`popsift_tpu.eval.repeatability` (numpy
only); its functions are held to the original's source
(tests/test_torch_imports.py) and run on the port's results: the
Mikolajczyk-Schmid repeatability and matching score of one image pair
(``evaluate_pair``), each keypoint's first descriptor from an
``api.FeaturesHost`` (``strongest_descriptor_per_keypoint``, which
``cli/sfm.py`` calls), and the synthetic-Oxford helpers
(``warp_image``, ``synthetic_scene``, ``protocol_homographies``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def project(H: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Apply a 3x3 homography to [N, 2] points."""
    p = np.concatenate([xy, np.ones((len(xy), 1), xy.dtype)], axis=1)
    q = p @ H.T
    return q[:, :2] / np.maximum(np.abs(q[:, 2:3]), 1e-12) * np.sign(
        q[:, 2:3] + (q[:, 2:3] == 0))


@dataclass
class PairScores:
    repeatability: float
    matching_score: float
    n_common: int
    n_repeated: int
    n_matched: int


def evaluate_pair(kp_a, desc_a, kp_b, desc_b, H_ab, shape_b,
                  eps: float = 2.5) -> PairScores:
    """Score detector/descriptor quality for one image pair.

    kp_*: [N, 2] keypoint positions (x, y); desc_*: [N, 128] descriptors
    (one per keypoint — pick the strongest orientation upstream);
    H_ab: homography mapping A pixel coords to B; shape_b: (H, W) of B.
    """
    kp_a = np.asarray(kp_a, np.float64)
    kp_b = np.asarray(kp_b, np.float64)
    proj = project(np.asarray(H_ab, np.float64), kp_a)

    hb, wb = shape_b
    vis = ((proj[:, 0] >= 0) & (proj[:, 0] < wb)
           & (proj[:, 1] >= 0) & (proj[:, 1] < hb))
    n_common = int(vis.sum())
    if n_common == 0 or len(kp_b) == 0:
        return PairScores(0.0, 0.0, 0, 0, 0)

    # pairwise distances projected-A x B
    d = np.linalg.norm(proj[vis][:, None, :] - kp_b[None, :, :], axis=2)
    repeated = d.min(axis=1) <= eps
    n_repeated = int(repeated.sum())

    # descriptor NN among all B descriptors; a match is correct when the
    # descriptor NN is geometrically consistent (within eps of the
    # projected position)
    da = np.asarray(desc_a, np.float32)[vis]
    db = np.asarray(desc_b, np.float32)
    sim = da @ db.T
    nn_desc = sim.argmax(axis=1)
    matched = d[np.arange(len(da)), nn_desc] <= eps
    n_matched = int(matched.sum())

    return PairScores(
        repeatability=n_repeated / max(n_common, 1),
        matching_score=n_matched / max(n_common, 1),
        n_common=n_common,
        n_repeated=n_repeated,
        n_matched=n_matched,
    )


def strongest_descriptor_per_keypoint(feats) -> tuple:
    """From a FeaturesHost, take each keypoint's first descriptor.
    Returns (kp [N,2], desc [N,128]) for keypoints that have one."""
    kp, desc = [], []
    by_kp = {}
    for di, k in enumerate(feats.desc_to_kp):
        by_kp.setdefault(int(k), di)
    for i in range(len(feats.x)):
        if i in by_kp:
            kp.append((feats.x[i], feats.y[i]))
            desc.append(feats.descriptors[by_kp[i]])
    return (np.asarray(kp, np.float32).reshape(-1, 2),
            np.asarray(desc, np.float32).reshape(-1, 128))


def warp_image(img: np.ndarray, H: np.ndarray,
               out_shape=None) -> np.ndarray:
    """Inverse-warp a grayscale uint8 image with a homography (bilinear,
    zero outside). Reference-quality synthetic ground truth for offline
    evaluation when the Oxford dataset is unavailable."""
    h, w = img.shape if out_shape is None else out_shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    src = project(np.linalg.inv(np.asarray(H, np.float64)), pts)
    sx, sy = src[:, 0], src[:, 1]
    valid = (sx >= 0) & (sx <= img.shape[1] - 1) & \
            (sy >= 0) & (sy <= img.shape[0] - 1)
    x0 = np.clip(np.floor(sx), 0, img.shape[1] - 2).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, img.shape[0] - 2).astype(np.int64)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    f = img.astype(np.float64)
    val = (f[y0, x0] * (1 - fx) * (1 - fy) + f[y0, x0 + 1] * fx * (1 - fy)
           + f[y0 + 1, x0] * (1 - fx) * fy + f[y0 + 1, x0 + 1] * fx * fy)
    out = np.where(valid, val, 0.0).reshape(h, w)
    return np.clip(out, 0, 255).astype(np.uint8)


def synthetic_scene(h: int = 480, w: int = 640, seed: int = 0) -> np.ndarray:
    """Deterministic textured test scene (sinusoid field + Gaussian
    blobs) used by the offline Oxford-protocol fallback and the OpenCV
    parity gate. Rich in corners/blobs across scales so all SIFT stages
    get exercised."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 90 + 45 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
    for _ in range(24):
        cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
        s = rng.uniform(2, 26)
        img += rng.uniform(50, 130) * rng.choice([-1, 1]) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255).astype(np.uint8)


def protocol_homographies(h: int, w: int):
    """The 5 synthetic-Oxford warps (rotation / scale / perspective)
    shared by evaluate.py and the cv2 parity gate."""
    out = []
    for ang, scale, px in [(3, 1.0, 0), (8, 1.0, 0), (0, 0.85, 0),
                           (5, 0.9, 1e-5), (12, 0.8, 2e-5)]:
        a = np.deg2rad(ang)
        cxy = np.array([w / 2, h / 2])
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        A = scale * R
        t = cxy - A @ cxy
        out.append(np.array([[A[0, 0], A[0, 1], t[0]],
                             [A[1, 0], A[1, 1], t[1]],
                             [px, px / 2, 1.0]]))
    return out
