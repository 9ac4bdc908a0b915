"""Synthetic SfM scenes: numpy versions of the JAX package's test scene
makers, for the card tests (``tests/test_torch_*_cuda.py``) and the
tools (neither may import jax or the JAX package's tests).

``make_multiview`` / ``tracks_from_gt`` are
tests/test_sfm_incremental.py's, ``make_sequence`` / ``tracks_from_vis``
tests/test_sfm_scale.py's, ``random_rotation`` / ``view_graph``
tests/test_global_sfm.py's ``_rand_rot`` / ``_graph``, with the same
draws from the caller's numpy generator; each rotation comes from the
port's ``exp_so3`` on a CPU tensor, so coordinates agree with the
originals to f32 rounding (tests/test_torch_sfm_scenes.py holds them
within 1e-5, indices equal).

``ba_scene``, ``focal_scene``, ``pnp_scene`` and ``averaging_problems``
are the card tests' bundle adjustment, shared-focal, PnP and averaging
problems (tests/test_torch_sfm_cuda.py, tests/test_torch_bal_cuda.py,
``tools/step_spread.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sfm.rotation import exp_so3
from ..sfm.tracks import Tracks

INTR = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
# the size of the repo's BA benchmark problem
# (scripts/bench_sfm_kernels.py:73-75)
BA_CAMS, BA_POINTS, BA_VIEWS = 100, 40_000, 5
BA_INTR = (500.0, 500.0, 320.0, 240.0)     # f = 500 on 640 x 480
# ransac_pnp_batch as IncrementalSfM calls it: pnp_chunk images
# (incremental.py:124), rows padded to a power of two (:424-433)
PNP_B, PNP_ROWS, PNP_VALID = 16, 2048, 1500
CG_NODES = 12000             # test_translation_averaging_cg_scales_to_10k


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


def _project(cams: np.ndarray, X: np.ndarray, obs_cam, obs_pt):
    """(uv, depth) of each observation through world->camera (rotvec, t)
    with BA_INTR."""
    f, _, cx, cy = BA_INTR
    R = _rotation(cams[:, :3]).astype(np.float64)
    Xc = np.einsum("oij,oj->oi", R[obs_cam], X[obs_pt]) + cams[obs_cam, 3:]
    uv = np.stack([f * Xc[:, 0] / Xc[:, 2] + cx, f * Xc[:, 1] / Xc[:, 2] + cy],
                  1)
    return uv, Xc[:, 2]


def ba_scene(seed: int, noise_px: float = 0.0, outliers: float = 0.0,
             n_cams: int = BA_CAMS, n_points: int = BA_POINTS,
             views: int = BA_VIEWS):
    """A BA problem with real geometry: cameras on a 180-degree arc of
    radius 8 round points in a 4 x 4 x 4 cube, each looking at the
    centre with a small tilt and roll; each point seen by ``views``
    cameras drawn at random; every point in front of its cameras. The
    start is perturbed as tests/test_sfm.py::_make_ba_problem perturbs
    it (cameras by 0.01, points by 0.05, camera 0 exact and fixed);
    ``outliers`` of the observations moved by N(0, 80 px). Returns (the
    problem's fields as numpy arrays, true cameras)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n_points, 3))
    a = np.linspace(-np.pi / 2, np.pi / 2, n_cams)
    i = np.arange(n_cams)
    w = np.stack([0.05 * np.sin(3.1 * i + 0.5), a,
                  0.05 * np.cos(2.3 * i)], 1).astype(np.float32)
    C = np.stack([8 * np.sin(a), 0.5 * np.sin(2 * a + 1.0), -8 * np.cos(a)],
                 1)
    R = _rotation(w).astype(np.float64)
    cams_gt = np.concatenate([w, -np.einsum("nij,nj->ni", R, C)], 1
                             ).astype(np.float32)
    obs_cam = np.argsort(rng.random((n_points, n_cams)), 1)[:, :views]
    obs_cam = obs_cam.reshape(-1)
    obs_pt = np.repeat(np.arange(n_points), views)
    uv, depth = _project(cams_gt, X, obs_cam, obs_pt)
    if not (depth > 0).all():
        raise ValueError("a BA scene point lies behind a camera")
    if noise_px:
        uv += rng.normal(0, noise_px, uv.shape)
    if outliers:
        bad = rng.choice(len(uv), int(outliers * len(uv)), replace=False)
        uv[bad] += rng.normal(0, 80.0, (len(bad), 2))
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    fields = dict(cams=cams0, points=(X + rng.normal(0, 0.05, X.shape)),
                  intr=np.array(BA_INTR), obs_cam=obs_cam, obs_pt=obs_pt,
                  obs_uv=uv, obs_valid=np.ones(len(uv), bool),
                  cam_fixed=fixed)
    return fields, cams_gt


def focal_scene():
    """tests/test_sfm.py:163-209's scene (8 tilted cameras round 80
    points, seed 11), the shared focal 5 % off. Returns (the problem's
    fields, the true focal)."""
    rng = np.random.default_rng(11)
    f = 500.0
    n_cams, n_pts = 8, 80
    X = rng.uniform([-2, -2, -2], [2, 2, 2],
                    size=(n_pts, 3)).astype(np.float32)
    cams_gt = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams * 0.35
        C = np.array([8 * np.sin(ang), 3.0 * np.sin(2 * ang + 1.0),
                      -8 * np.cos(ang)], np.float32)
        w = np.array([0.25 * np.sin(3.1 * i + 0.5), ang,
                      0.1 * np.cos(2.3 * i)], np.float32)
        R = _rotation(w[None])[0]
        cams_gt.append(np.concatenate([w, (-R @ C).astype(np.float32)]))
    cams_gt = np.stack(cams_gt)
    obs_cam = np.repeat(np.arange(n_cams), n_pts)
    obs_pt = np.tile(np.arange(n_pts), n_cams)
    uv = np.concatenate([
        _project(cams_gt[ci:ci + 1], X, np.zeros(n_pts, int),
                 np.arange(n_pts))[0] + rng.normal(0, 0.2, (n_pts, 2))
        for ci in range(n_cams)])
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(cams=cams0, points=X0,
                intr=np.array([f * 1.05, f * 1.05, 320.0, 240.0]),
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv,
                obs_valid=np.ones(len(uv), bool), cam_fixed=fixed), f


def pnp_scene(seed: int):
    """PNP_B images for ransac_pnp_batch: each a random pose and about
    PNP_VALID valid rows (of PNP_ROWS) of points 4-8 in front of the
    camera, a quarter of them outliers uniform in [-0.5, 0.5], the
    inliers' normalized coordinates with N(0, 1e-3) noise (as
    tests/test_cv2_sfm_parity.py:110-120). Returns (X [B,N,3], x [B,N,2],
    valid [B,N], inlier truth [B,N], R [B,3,3], t [B,3], the median
    depth of each image's points [B])."""
    rng = np.random.default_rng(seed)
    rows = PNP_ROWS
    Xs, xs, vs, truth, Rs, ts, depth = [], [], [], [], [], [], []
    for _ in range(PNP_B):
        w = rng.normal(0, 0.3, 3)
        R = _rotation(w[None])[0].astype(np.float64)
        t = rng.uniform([-1, -1, -1], [1, 1, 1])
        Xc = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (rows, 3))
        X = (Xc - t) @ R                       # world points: R^T (Xc - t)
        x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (rows, 2))
        out = rng.random(rows) < 0.25
        x[out] = rng.uniform(-0.5, 0.5, (int(out.sum()), 2))
        valid = np.arange(rows) < PNP_VALID + int(rng.integers(-100, 101))
        Xs.append(X)
        xs.append(x)
        vs.append(valid)
        truth.append(valid & ~out)
        Rs.append(R)
        ts.append(t)
        depth.append(np.median(Xc[:, 2]))
    f32 = lambda a: torch.from_numpy(np.stack(a).astype(np.float32))
    return (f32(Xs), f32(xs), torch.from_numpy(np.stack(vs)),
            np.stack(truth), np.stack(Rs), np.stack(ts), np.array(depth))


def averaging_problems():
    """The inputs of tests/test_global_sfm.py's solver tests: 30 rotations
    (seed 0) as (n, ei, ej, R_rel, R_gt), the 24-node translation problem
    (seed 5) as (n, ei, ej, d) and the CG_NODES-node one (seed 9) as (n,
    ei, ej, d, C_gt)."""
    rng = np.random.default_rng(0)
    n = 30
    R_gt = np.stack([random_rotation(rng) for _ in range(n)])
    ei, ej = view_graph(rng, n)
    E = len(ei)
    R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei])
    noise = np.stack([random_rotation(rng, 0.005) for _ in range(E)])
    R_rel = np.einsum("eab,ebc->eac", noise, R_rel)
    bad = rng.choice(E, E // 10, replace=False)
    R_rel[bad] = np.stack([random_rotation(rng) for _ in bad])
    rot = (n, ei, ej, R_rel.astype(np.float32), R_gt)

    rng = np.random.default_rng(5)
    n = 24
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ei, ej = view_graph(rng, n)
    d = C_gt[ej] - C_gt[ei]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(0, 0.003, d.shape)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    small = (n, ei, ej, d)

    rng = np.random.default_rng(9)
    n = CG_NODES
    C_gt = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ei = np.arange(n, dtype=np.int32)
    ej = np.roll(ei, -1)
    ch_i = rng.integers(0, n, 3 * n).astype(np.int32)
    ch_j = rng.integers(0, n, 3 * n).astype(np.int32)
    keep = ch_i != ch_j
    ei = np.concatenate([ei, ch_i[keep]])
    ej = np.concatenate([ej, ch_j[keep]])
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
         ).astype(np.float32)
    return rot, small, (n, ei, ej, d, C_gt)
