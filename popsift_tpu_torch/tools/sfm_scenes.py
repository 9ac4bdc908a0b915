"""Synthetic SfM scenes: numpy versions of the JAX package's test scene
makers, for ``chip_smoke.py`` and ``tools/sfm_scale.py`` (neither may
import jax or the tests).

``make_multiview`` / ``tracks_from_gt`` are
tests/test_sfm_incremental.py's, ``make_sequence`` / ``tracks_from_vis``
tests/test_sfm_scale.py's, ``random_rotation`` / ``view_graph``
tests/test_global_sfm.py's ``_rand_rot`` / ``_graph``, with the same
draws from the caller's numpy generator; each rotation comes from the
port's ``exp_so3`` on a CPU tensor, so coordinates agree with the
originals to f32 rounding (tests/test_torch_sfm_scenes.py holds them
within 1e-5, indices equal).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sfm.rotation import exp_so3
from ..sfm.tracks import Tracks

INTR = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def _rotation(w: np.ndarray) -> np.ndarray:
    return exp_so3(torch.from_numpy(np.asarray(w, np.float32))).numpy()


def make_multiview(rng, n_pts=80, n_cams=5, noise=0.0):
    """``n_pts`` points in a [-2, 2]^2 x [4, 8] box seen by every one of
    ``n_cams`` cameras on a short diagonal path, uv with N(0, noise) px.
    Returns (X, [(R, t)], {image: uv})."""
    X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n_pts, 3)).astype(np.float32)
    cams = []
    for i in range(n_cams):
        w = np.array([0.03 * i, -0.04 * i, 0.02 * i], np.float32)
        R = _rotation(w)
        C = np.array([0.4 * i, 0.05 * i, -0.08 * i], np.float32)
        cams.append((R.astype(np.float32), (-R @ C).astype(np.float32)))
    fx, fy, cx, cy = INTR
    kps = {}
    for i, (R, t) in enumerate(cams):
        Xc = X @ R.T + t
        x = Xc[:, :2] / Xc[:, 2:3]
        uv = np.stack([fx * x[:, 0] + cx, fy * x[:, 1] + cy], -1)
        if noise > 0:
            uv = uv + rng.normal(0, noise, uv.shape)
        kps[i] = uv.astype(np.float32)
    return X, cams, kps


def tracks_from_gt(kps, n_pts):
    """Ground-truth tracks: feature j in every image is point j."""
    tid, iid, fid, uv = [], [], [], []
    for img, k in kps.items():
        for j in range(n_pts):
            tid.append(j)
            iid.append(img)
            fid.append(j)
            uv.append(k[j])
    return Tracks(track_id=np.asarray(tid), image_id=np.asarray(iid),
                  feature_id=np.asarray(fid),
                  uv=np.stack(uv).astype(np.float32), n_tracks=n_pts)


def make_sequence(rng, n_pts=240, n_cams=40, noise=0.25,
                  window=8, span=None, vis_pts=None):
    """Forward-moving camera over a point cloud; each camera sees a
    sliding subset of points (video-like visibility, not all-see-all).

    ``span``: x-extent of the cloud, by default the fixed [-4, 12] box;
    long sequences stretch it with the trajectory (cameras advance 0.25
    a frame). ``vis_pts``: fixed number of visible points per camera
    (overrides the fraction-of-n_pts ``window`` rule). Returns (X,
    [(R, t)], {image: uv}, {image: point ids})."""
    x_hi = 12.0 if span is None else float(span)
    X = rng.uniform([-4, -3, 4], [x_hi, 3, 10],
                    size=(n_pts, 3)).astype(np.float32)
    X = X[np.argsort(X[:, 0])]           # sort points along the path
    fx, fy, cx, cy = INTR
    cams, kps, vis = [], {}, {}
    for i in range(n_cams):
        w = np.array([0.02 * np.sin(i / 5), -0.015 * i / n_cams,
                      0.01 * np.cos(i / 7)], np.float32)
        R = _rotation(w).astype(np.float32)
        C = np.array([0.25 * i, 0.05 * np.sin(i / 3.0), -0.02 * i],
                     np.float32)
        t = (-R @ C).astype(np.float32)
        cams.append((R, t))
        # sliding visibility window over the path-sorted points
        lo = int(i / n_cams * n_pts * 0.6)
        hi = min(n_pts, lo + (int(vis_pts) if vis_pts
                              else int(n_pts * (window / 10))))
        ids = np.arange(lo, hi)
        Xc = X[ids] @ R.T + t
        ok = Xc[:, 2] > 0.5
        ids = ids[ok]
        Xc = Xc[ok]
        x = Xc[:, :2] / Xc[:, 2:3]
        uv = np.stack([fx * x[:, 0] + cx, fy * x[:, 1] + cy], -1)
        uv = uv + rng.normal(0, noise, uv.shape)
        kps[i] = uv.astype(np.float32)
        vis[i] = ids
    return X, cams, kps, vis


def tracks_from_vis(kps, vis):
    """Tracks from per-image visible point ids: feature j of image i is
    point ``vis[i][j]``."""
    tid, iid, fid, uv = [], [], [], []
    for img in kps:
        for j, tr in enumerate(vis[img]):
            tid.append(int(tr))
            iid.append(img)
            fid.append(j)
            uv.append(kps[img][j])
    n_tracks = int(max(tid)) + 1
    return Tracks(track_id=np.asarray(tid), image_id=np.asarray(iid),
                  feature_id=np.asarray(fid),
                  uv=np.stack(uv).astype(np.float32), n_tracks=n_tracks)


def random_rotation(rng, scale=1.0) -> np.ndarray:
    """exp of a rotation vector drawn N(0, scale) per axis."""
    return _rotation(rng.normal(0, scale, 3).astype(np.float32))


def view_graph(rng, n, extra=4):
    """Connected random graph: chain + ``extra`` random edges a node,
    each as (min, max)."""
    ei = list(range(n - 1))
    ej = list(range(1, n))
    for _ in range(extra * n):
        i, j = rng.integers(0, n, 2)
        if i != j:
            ei.append(min(i, j))
            ej.append(max(i, j))
    return np.asarray(ei, np.int32), np.asarray(ej, np.int32)


def camera_centers(rec, images) -> np.ndarray:
    """Centers -R^T t of ``images`` in a Reconstruction, or in a list of
    (R, t) pairs indexed by image."""
    if isinstance(rec, (list, tuple)):
        return np.stack([-(rec[i][0].T @ rec[i][1]) for i in images])
    return np.stack([-(rec.cam_R[i].T @ rec.cam_t[i]) for i in images])
