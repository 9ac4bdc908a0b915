"""A synthetic BAL problem (NumPy only): a city street with points on its
facades, its paving and the walls at its ends, and cameras along it
looking at them, observed through BAL's camera model (``sfm/bal.py``).

    fields, truth = bal_scene(seed)       # Dubrovnik-88's counts

``fields`` holds a BAL problem's arrays (``sfm/bal.py::read_bal``'s
keys): the start to adjust and the noisy observations; ``truth`` the
cameras and points they were made from. Every value that BAL does not
publish is a constant below.
"""

from __future__ import annotations

import numpy as np

# the image: 1024 x 768 px, coordinates about its centre
HALF_W, HALF_H = 512.0, 384.0
# true cameras: focal length (px), radial distortion, uniform
FOCAL = (700.0, 1400.0)
K1 = (-0.12, 0.02)
K2 = (-0.01, 0.01)
# the street (m): x along it, CAM_SPACING a camera long (123.2 m for 88),
# y across (facades at +-STREET_W / 2), z up
CAM_SPACING, STREET_W, FACADE_H = 1.4, 10.0, 12.0
END_MARGIN = 10.0            # the end walls stand this far past each end
RELIEF = 0.1                 # facade relief, m (normal, across the facade)
END_H = 30.0                 # the end walls (city wall, bell tower), m
SHARES = (0.8, 0.15, 0.05)   # points on facades, paving, end walls
EYE_Z = (1.5, 1.8)           # camera height, m
EYE_Y = 0.25                 # cameras stand within +-EYE_Y x STREET_W of
#                              the street's middle
HEADINGS = (0.2, 0.2, 0.6)   # cameras facing the +y, -y facade, the street
YAW_JITTER = np.radians(35.0)
PITCH = np.radians((-5.0, 15.0))
ROLL_SIGMA = np.radians(2.0)
DEPTH = (3.0, 150.0)         # a camera sees a point between these, m
MIN_SEEN = 0.05              # a camera that sees fewer of the candidate
#                              points is drawn again
# track lengths: 2 + floor(Lomax(TRACK_ALPHA) x TRACK_SCALE), at most the
# cameras that see the point, then moved one by one to the exact sum
TRACK_ALPHA, TRACK_SCALE = 2.5, 6.7
NOISE_PX = 0.5               # Gaussian pixel noise of each coordinate
# the start: each camera turned by a rotation of N(0, ROT_SIGMA) a axis,
# moved by N(0, T_SIGMA) m a axis, its focal length times 1 + N(0,
# F_SIGMA), k1 = k2 = 0; each point moved by N(0, POINT_SIGMA) m a axis
ROT_SIGMA, T_SIGMA, F_SIGMA, POINT_SIGMA = 0.01, 0.1, 0.03, 0.1


def rotmat(w: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation matrices [..., 3, 3] from rotation vectors."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(th[..., 0], 1e-300)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def rotvec(R: np.ndarray) -> np.ndarray:
    """Rotation vectors [..., 3] of rotation matrices, through the unit
    quaternion (Shepperd's choice of its largest component, so stable up
    to and at pi)."""
    R = np.asarray(R, np.float64)
    m = lambda i, j: R[..., i, j]  # noqa: E731
    q = np.stack([1 + m(0, 0) + m(1, 1) + m(2, 2),
                  1 + m(0, 0) - m(1, 1) - m(2, 2),
                  1 - m(0, 0) + m(1, 1) - m(2, 2),
                  1 - m(0, 0) - m(1, 1) + m(2, 2)], -1)   # 4 (w, x, y, z)^2
    k = q.argmax(-1)
    s = np.sqrt(np.take_along_axis(q, k[..., None], -1)[..., 0])
    a = (m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1))
    b = (m(0, 1) + m(1, 0), m(0, 2) + m(2, 0), m(1, 2) + m(2, 1))
    # case k holds 4 c_k (w, x, y, z), c_k = s / 2 the largest component
    cases = np.stack([np.stack([s * s, a[0], a[1], a[2]], -1),
                      np.stack([a[0], s * s, b[0], b[1]], -1),
                      np.stack([a[1], b[0], s * s, b[2]], -1),
                      np.stack([a[2], b[1], b[2], s * s], -1)], -2)
    quat = np.take_along_axis(cases, k[..., None, None], -2)[..., 0, :] \
        / (2.0 * s[..., None])
    quat = quat * np.where(quat[..., :1] < 0, -1.0, 1.0)
    v = quat[..., 1:]
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v * (2.0 * np.arctan2(n, quat[..., :1])) / np.maximum(n, 1e-300)


def project(cams: np.ndarray, X: np.ndarray) -> tuple:
    """BAL's projection of points ``X`` [n, 3] through cameras ``cams``
    [n, 9], in f64: (uv [n, 2], P_z [n]); a point in front has P_z < 0."""
    P = np.einsum("nij,nj->ni", rotmat(cams[:, :3]), X) + cams[:, 3:6]
    q = -P[:, :2] / P[:, 2:]
    r2 = (q * q).sum(1, keepdims=True)
    return cams[:, 6:7] * (1 + cams[:, 7:8] * r2
                           + cams[:, 8:9] * r2 * r2) * q, P[:, 2]


def _cameras(rng, n: int, length: float) -> np.ndarray:
    """True cameras [n, 9] along a street of ``length``, looking at a
    facade or along the street."""
    C = np.stack([rng.uniform(0.0, length, n),
                  rng.uniform(-EYE_Y, EYE_Y, n) * STREET_W,
                  rng.uniform(*EYE_Z, n)], 1)
    side = rng.choice(4, n, p=HEADINGS[:2] + (HEADINGS[2] / 2,) * 2)
    yaw = np.array([0.5, -0.5, 0.0, 1.0])[side] * np.pi \
        + rng.uniform(-YAW_JITTER, YAW_JITTER, n)
    pitch = rng.uniform(*PITCH, n)
    d = np.stack([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch),
                  np.sin(pitch)], 1)
    right = np.cross(d, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    z_c = -d                                  # BAL's cameras look down -z
    y_c = np.cross(z_c, right)
    R = np.stack([right, y_c, z_c], 1)        # rows: camera axes in world
    R = rotmat(np.stack([np.zeros(n), np.zeros(n),
                         rng.normal(0.0, ROLL_SIGMA, n)], 1)) @ R
    cams = np.zeros((n, 9))
    cams[:, :3] = rotvec(R)
    cams[:, 3:6] = -np.einsum("nij,nj->ni", R, C)
    cams[:, 6] = rng.uniform(*FOCAL, n)
    cams[:, 7] = rng.uniform(*K1, n)
    cams[:, 8] = rng.uniform(*K2, n)
    return cams


def _candidates(rng, n: int, length: float) -> np.ndarray:
    """``n`` points on the facades, the paving and the end walls of a
    street of ``length``."""
    kind = rng.choice(3, n, p=SHARES)
    x = rng.uniform(-END_MARGIN, length + END_MARGIN, n)
    y = rng.uniform(-0.5, 0.5, n) * STREET_W
    z = rng.uniform(0.0, FACADE_H, n)
    facade = kind == 0
    y[facade] = np.where(rng.random(facade.sum()) < 0.5, 0.5, -0.5) \
        * STREET_W + rng.normal(0.0, RELIEF, facade.sum())
    z[kind == 1] = 0.0
    ends = kind == 2
    z[ends] *= END_H / FACADE_H
    x[ends] = np.where(rng.random(ends.sum()) < 0.5, -END_MARGIN,
                       length + END_MARGIN) \
        + rng.normal(0.0, RELIEF, ends.sum())
    return np.stack([x, y, z], 1)


def _visible(cams: np.ndarray, X: np.ndarray) -> np.ndarray:
    """bool [n_points, n_cams]: the point lies in front of the camera,
    between DEPTH's distances, and inside the frame both through the
    pinhole and through the distortion (so that no point beyond the
    frame folds back into it)."""
    vis = np.zeros((len(X), len(cams)), bool)
    for c, (cam, R) in enumerate(zip(cams, rotmat(cams[:, :3]))):
        P = X @ R.T + cam[3:6]
        q = -P[:, :2] / P[:, 2:]
        r2 = (q * q).sum(1, keepdims=True)
        inside = np.ones(len(X), bool)
        for uv in (cam[6] * q,
                   cam[6] * (1 + cam[7] * r2 + cam[8] * r2 * r2) * q):
            inside &= ((np.abs(uv[:, 0]) <= HALF_W)
                       & (np.abs(uv[:, 1]) <= HALF_H))
        vis[:, c] = (-P[:, 2] >= DEPTH[0]) & (-P[:, 2] <= DEPTH[1]) & inside
    return vis


def _track_lengths(rng, seen: np.ndarray, n_obs: int) -> np.ndarray:
    """Heavy-tailed track lengths, at least 2 and at most ``seen`` (the
    cameras that see each point), summing to ``n_obs``."""
    L = 2 + np.floor(rng.pareto(TRACK_ALPHA, len(seen)) * TRACK_SCALE)
    L = np.minimum(L.astype(np.int64), seen)
    diff = n_obs - int(L.sum())
    room = seen - L if diff > 0 else L - 2
    if abs(diff) > int(room.sum()):
        raise ValueError(f"the scene cannot hold {n_obs} observations")
    if diff:
        slots = np.repeat(np.arange(len(L)), room)
        pick = rng.choice(len(slots), abs(diff), replace=False)
        L += np.sign(diff) * np.bincount(slots[pick], minlength=len(L))
    return L


def bal_scene(seed, n_cams: int = 88, n_points: int = 64298,
              n_obs: int = 383937) -> tuple:
    """(fields, truth): a BAL problem of ``n_cams`` cameras, ``n_points``
    points and ``n_obs`` observations made from ``seed`` (what
    ``numpy.random.default_rng`` takes: an int, or a list such as
    ``[seed, k]``), Dubrovnik-88's counts by default. ``fields`` has
    ``read_bal``'s keys with the perturbed start; ``truth`` the true
    ``cams`` and ``points``."""
    rng = np.random.default_rng(seed)
    length = CAM_SPACING * n_cams
    cams = _cameras(rng, n_cams, length)
    X = _candidates(rng, n_points + n_points // 4, length)
    vis = _visible(cams, X)
    weak = vis.sum(0) < MIN_SEEN * len(X)
    while weak.any():
        cams[weak] = _cameras(rng, int(weak.sum()), length)
        vis[:, weak] = _visible(cams[weak], X)
        weak = vis.sum(0) < MIN_SEEN * len(X)
    kept, seen = [], []
    while True:
        ok = vis.sum(1) >= 2
        kept.append(X[ok])
        seen.append(vis[ok])
        if sum(len(x) for x in kept) >= n_points:
            break
        X = _candidates(rng, n_points + n_points // 4, length)
        vis = _visible(cams, X)
    X = np.concatenate(kept)[:n_points]
    vis = np.concatenate(seen)[:n_points]
    L = _track_lengths(rng, vis.sum(1), n_obs)
    first = np.argsort(np.where(vis, rng.random(vis.shape), 2.0), 1)
    take = np.arange(n_cams)[None, :] < L[:, None]
    obs_cam = np.sort(np.where(take, first, n_cams), 1)[take]
    obs_pt = np.repeat(np.arange(n_points), L)
    uv, _ = project(cams[obs_cam], X[obs_pt])
    uv += rng.normal(0.0, NOISE_PX, uv.shape)
    turn = rotmat(rng.normal(0.0, ROT_SIGMA, (n_cams, 3)))
    start = cams.copy()
    start[:, :3] = rotvec(turn @ rotmat(cams[:, :3]))
    start[:, 3:6] += rng.normal(0.0, T_SIGMA, (n_cams, 3))
    start[:, 6] *= 1.0 + rng.normal(0.0, F_SIGMA, n_cams)
    start[:, 7:] = 0.0
    fields = dict(cams=start, points=X + rng.normal(0.0, POINT_SIGMA,
                                                    X.shape),
                  obs_cam=obs_cam.astype(np.int64),
                  obs_pt=obs_pt.astype(np.int64), obs_uv=uv)
    return fields, dict(cams=cams, points=X)
