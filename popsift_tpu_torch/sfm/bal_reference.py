"""Plain reference of Levenberg-Marquardt bundle adjustment on BAL
problems, for holding ``ba.bundle_adjust`` on 9-wide cameras to it.

Plain ``torch`` in float64 (or the ``dtype`` asked for), TF32 off,
imports nothing of the port. BAL's camera model (Agarwal, Snavely, Seitz,
Szeliski, "Bundle Adjustment in the Large", ECCV 2010): a camera is a
Rodrigues rotation w, a translation t, a focal length f and radial
distortion k1, k2; a point X is seen at

    P = R(w) X + t,  p = -P_xy / P_z,  uv = f (1 + k1 |p|^2 + k2 |p|^4) p

(pixels about the image centre). The loss is the plain sum of squared
residuals. Each iteration, as the program's schedule runs it:

1. residuals and the analytic Jacobians of the projection, written out
   by hand (:func:`project`; no autodiff);
2. the damped normal equations, lam I added to the camera and the point
   diagonal blocks alike; the point blocks eliminated: the reduced
   camera system S = Hcc + lam I - sum_p sum_{a, b in track(p)}
   W_a (Hpp_p + lam I)^-1 W_b^T, formed from each track's pairs of
   observations (W_o = Jc_o^T Jp_o), with no dense camera-point
   coupling;
3. S solved by LU, the points' steps back-substituted;
4. the step accepted when the trial cost is below the cost, lam halved
   on acceptance and multiplied by 4 on rejection; ``iters`` iterations
   from ``lam0`` = 1e-3.

Departures from BAL's and Ceres' ``bundle_adjuster``: Ceres damps with
Jacobi-scaled Marquardt (lam times the diagonal of J^T J, within a trust
region) where both sides here add lam I; a fixed number of iterations
with the program's accept rule, where Ceres stops on tolerances; no
camera is fixed (as BAL), so the similarity gauge is held by lam alone;
no Ceres inner iterations, reordering or robust loss. With a ``dtype``
below float32 (the control), every product and sum is in ``dtype`` and
only the linear solves (LU, the 3 x 3 inverses) run in float32, which
torch has no lower form of.
"""

from __future__ import annotations

import contextlib

import torch

CAM = 9
PAIR_CHUNK = 1 << 19     # track pairs a block product at a time


def _hat(v):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rotation(w):
    """Rodrigues: R [..., 3, 3] of rotation vectors w [..., 3]."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    K = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    small = th2 < 1e-16
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / torch.where(
        small, torch.ones_like(th), th))
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(th)) / torch.where(small,
                                                      torch.ones_like(th2),
                                                      th2))
    return eye + a * K + b * (K @ K)


def project(cams, X, jacobians: bool = False):
    """BAL's projection of points X [n, 3] through cameras [n, 9]:
    uv [n, 2], and with ``jacobians`` (uv, d uv / d cam [n, 2, 9],
    d uv / d X [n, 2, 3]) by the chain rule written out:

    d(R X)/dw = -R [X]x (w w^T + (R^T - I) [w]x) / |w|^2 (Gallego and
    Yezzi, 2015; -[X]x below |w| = 1e-8), dP/dt = I, dP/dX = R;
    dp/dP = [[-1/Pz, 0, Px/Pz^2], [0, -1/Pz, Py/Pz^2]];
    duv/dp = f (d I + (2 k1 + 4 k2 r^2) p p^T), d = 1 + k1 r^2 + k2 r^4;
    duv/df = d p, duv/dk1 = f r^2 p, duv/dk2 = f r^4 p.
    """
    w, t = cams[:, :3], cams[:, 3:6]
    f, k1, k2 = cams[:, 6:7], cams[:, 7:8], cams[:, 8:9]
    R = rotation(w)
    RX = (R @ X[:, :, None])[..., 0]
    P = RX + t
    p = -P[:, :2] / P[:, 2:]
    r2 = (p * p).sum(1, keepdim=True)
    d = 1 + k1 * r2 + k2 * r2 * r2
    uv = f * d * p
    if not jacobians:
        return uv
    n = len(X)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    duv_dp = f[:, :, None] * (d[:, :, None] * eye2
                              + (2 * k1 + 4 * k2 * r2)[:, :, None]
                              * p[:, :, None] * p[:, None, :])
    iz = 1 / P[:, 2]
    dp_dP = torch.zeros(n, 2, 3, dtype=X.dtype, device=X.device)
    dp_dP[:, 0, 0] = -iz
    dp_dP[:, 1, 1] = -iz
    dp_dP[:, 0, 2] = P[:, 0] * iz * iz
    dp_dP[:, 1, 2] = P[:, 1] * iz * iz
    duv_dP = duv_dp @ dp_dP                                  # [n, 2, 3]
    th2 = (w * w).sum(1)[:, None, None]
    small = th2 < 1e-16
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    big = (w[:, :, None] * w[:, None, :]
           + (R.transpose(1, 2) - eye3) @ _hat(w)) \
        / torch.where(small, torch.ones_like(th2), th2)
    dRX_dw = torch.where(small, -_hat(X), -R @ _hat(X) @ big)
    Jc = torch.cat([duv_dP @ dRX_dw, duv_dP,
                    (d * p)[:, :, None], (f * r2 * p)[:, :, None],
                    (f * r2 * r2 * p)[:, :, None]], 2)
    return uv, Jc, duv_dP @ R


def _f32_at_least(x):
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _cost(cams, points, obs_cam, obs_pt, obs_uv):
    r = project(cams[obs_cam], points[obs_pt]) - obs_uv
    return (r * r).sum()


def _track_pairs(obs_pt, n_points):
    """Every ordered pair (a, b) of observations of one point, a == b
    included, as two index tensors."""
    order = torch.argsort(obs_pt, stable=True)
    L = torch.bincount(obs_pt, minlength=n_points)
    start = torch.cumsum(L, 0) - L
    La = L[obs_pt[order]]
    n = len(order)
    a = torch.repeat_interleave(torch.arange(n, device=obs_pt.device), La)
    pos = torch.arange(len(a), device=obs_pt.device) \
        - torch.repeat_interleave(torch.cumsum(La, 0) - La, La)
    b = start[obs_pt[order[a]]] + pos
    return order[a], order[b]


def step(cams, points, obs_cam, obs_pt, obs_uv, lam, pairs=None):
    """One damped Gauss-Newton step: (d cams [Nc, 9], d points [Np, 3],
    cost)."""
    Nc, Np = len(cams), len(points)
    dt, dev = cams.dtype, cams.device
    uv, Jc, Jp = project(cams[obs_cam], points[obs_pt], jacobians=True)
    r = uv - obs_uv
    cost = (r * r).sum()
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp = torch.zeros(Np, 3, 3, dtype=dt, device=dev).index_add_(
        0, obs_pt, Jp.transpose(1, 2) @ Jp) + lam * eye3
    Hpp_inv = torch.linalg.inv(_f32_at_least(Hpp)).to(dt)
    Hcc = torch.zeros(Nc, CAM, CAM, dtype=dt, device=dev).index_add_(
        0, obs_cam, Jc.transpose(1, 2) @ Jc)
    g_c = torch.zeros(Nc, CAM, dtype=dt, device=dev).index_add_(
        0, obs_cam, (Jc.transpose(1, 2) @ r[:, :, None])[..., 0])
    g_p = torch.zeros(Np, 3, dtype=dt, device=dev).index_add_(
        0, obs_pt, (Jp.transpose(1, 2) @ r[:, :, None])[..., 0])
    W = Jc.transpose(1, 2) @ Jp                              # [No, 9, 3]
    V = W @ Hpp_inv[obs_pt]                                  # W Hpp^-1
    if pairs is None:
        pairs = _track_pairs(obs_pt, Np)
    a_idx, b_idx = pairs
    S4 = torch.zeros(Nc * Nc, CAM, CAM, dtype=dt, device=dev)
    for s in range(0, len(a_idx), PAIR_CHUNK):
        a, b = a_idx[s:s + PAIR_CHUNK], b_idx[s:s + PAIR_CHUNK]
        S4.index_add_(0, obs_cam[a] * Nc + obs_cam[b],
                      V[a] @ W[b].transpose(1, 2))
    S = -S4.view(Nc, Nc, CAM, CAM).permute(0, 2, 1, 3).reshape(
        Nc * CAM, Nc * CAM)
    blocks = S.view(Nc, CAM, Nc, CAM)
    idx = torch.arange(Nc, device=dev)
    blocks[idx, :, idx, :] += Hcc + lam * torch.eye(CAM, dtype=dt,
                                                    device=dev)
    corr = torch.zeros(Nc, CAM, dtype=dt, device=dev).index_add_(
        0, obs_cam, (V @ g_p[obs_pt][:, :, None])[..., 0])
    rhs = -(g_c - corr).reshape(-1)
    dc = torch.linalg.solve(_f32_at_least(S), _f32_at_least(rhs)).to(
        dt).view(Nc, CAM)
    hpc = torch.zeros(Np, 3, dtype=dt, device=dev).index_add_(
        0, obs_pt, (W.transpose(1, 2) @ dc[obs_cam][:, :, None])[..., 0])
    dp = (Hpp_inv @ (-g_p - hpc)[:, :, None])[..., 0]
    return dc, dp, cost


@contextlib.contextmanager
def _no_tf32():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def bundle_adjust(cams, points, obs_cam, obs_pt, obs_uv, iters: int = 10,
                  lam0: float = 1e-3, dtype=torch.float64):
    """``iters`` LM iterations (the module's schedule) from cameras
    [Nc, 9] and points [Np, 3] on observations (``obs_cam``, ``obs_pt``
    [No], ``obs_uv`` [No, 2]), computed in ``dtype`` on the inputs'
    device. Returns (cameras, points, costs [iters]): the state and its
    cost after each iteration's accept or reject."""
    with _no_tf32():
        cams, points, obs_uv = (x.to(dtype) for x in (cams, points, obs_uv))
        pairs = _track_pairs(obs_pt, len(points))
        lam = torch.tensor(lam0, dtype=dtype, device=cams.device)
        costs = []
        for _ in range(iters):
            dc, dp, cost = step(cams, points, obs_cam, obs_pt, obs_uv, lam,
                                pairs)
            new_cams, new_points = cams + dc, points + dp
            new_cost = _cost(new_cams, new_points, obs_cam, obs_pt, obs_uv)
            ok = bool(new_cost < cost)
            if ok:
                cams, points, cost = new_cams, new_points, new_cost
            lam = lam * (0.5 if ok else 4.0)
            costs.append(cost)
        return cams, points, torch.stack(costs)


def reprojections(cams, points, obs_cam, obs_pt):
    """Each observation's projection [No, 2] in float64."""
    return project(cams[obs_cam].double(), points[obs_pt].double())
