"""Two-view geometry: batched RANSAC for the essential matrix and the
homography, pose recovery, triangulation.

Port of :mod:`popsift_tpu.sfm.twoview`. RANSAC is a batched
hypothesize-and-verify: S minimal problems solved at once by batched
small SVDs, every hypothesis scored against every correspondence in one
[S, N] pass. All f32, every product in full f32 whatever torch's TF32
switch says.

Random draws. JAX draws each hypothesis's sample ranks with
``jax.random.randint`` (threefry), which no torch generator reproduces.
So drawing is a step of its own here (:func:`draw_ranks`, from an
explicit ``torch.Generator``), and everything after it depends on the
ranks alone: the RANSAC entries take ``generator`` where JAX takes
``key``, or the ranks themselves (``ranks=``); given JAX's ranks they
choose JAX's hypothesis.

SVDs. Singular vectors differ in sign between solvers, and the two
equal singular values of an essential matrix leave its U and V free up
to a rotation; the models (up to scale and sign), the residuals, the
poses and the inlier masks do not depend on either.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..utils.f32 import full_f32
from ..utils.profiling import span
from .rotation import exp_so3, hat


# ---------------------------------------------------------------------------
# minimal solvers (batched)
# ---------------------------------------------------------------------------

def _const(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=like.dtype, device=like.device)


def _normalize_points(pts, valid):
    """Hartley normalization: zero-mean, mean distance sqrt(2).
    Returns (normalized points, the 3x3 map T)."""
    w = valid.to(pts.dtype)[:, None]
    n = torch.sum(w).clamp(min=1.0)
    mean = torch.sum(pts * w, 0) / n
    d = torch.sqrt(torch.sum((pts - mean) ** 2, 1) + 1e-30)
    mean_d = (torch.sum(d * w[:, 0]) / n).clamp(min=1e-12)
    scale = torch.full_like(mean_d, 2.0).sqrt() / mean_d
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, zero, -scale * mean[0]]),
                     torch.stack([zero, scale, -scale * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * scale, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of A
    [..., m, n] (the last row of Vh of the full SVD, as the JAX code
    takes it). Rows of zeros pad a wide A to square first: they leave
    that vector as it is and let a batch of small squares go to the
    batched solver."""
    m, n = A.shape[-2:]
    if m < n:
        A = torch.cat([A, A.new_zeros(*A.shape[:-2], n - m, n)], -2)
    return torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :]


def eight_point(x1, x2):
    """Batched 8-point fundamental/essential solver.

    x1, x2: [S, 8, 2] correspondences (normalized camera coords for E).
    Returns [S, 3, 3] rank-2-enforced matrices."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, torch.ones_like(u1)], -1)        # [S, 8, 9]
    F = _null_vector(A).reshape(-1, 3, 3)
    uF, sF, vtF = torch.linalg.svd(F)
    sF = torch.cat([sF[..., :2], torch.zeros_like(sF[..., 2:])], -1)
    return uF @ (sF[..., None] * vtF)


def essential_project(E):
    """Project onto the essential manifold: equal singular values."""
    u, s, vt = torch.linalg.svd(E)
    m = (s[..., 0] + s[..., 1]) * 0.5
    s2 = torch.stack([m, m, torch.zeros_like(m)], -1)
    return u @ (s2[..., None] * vt)


def homography_dlt(x1, x2):
    """Batched 4-point homography DLT. x1, x2: [S, 4, 2] -> [S, 3, 3]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], -1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    return _null_vector(torch.cat([r1, r2], -2)).reshape(-1, 3, 3)


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def _homogeneous(x):
    return torch.cat([x, x.new_ones(x.shape[0], 1)], -1)


def sampson_error(E, x1, x2):
    """Squared Sampson distance. E: [S,3,3]; x1/x2: [N,2] -> [S,N]."""
    h1, h2 = _homogeneous(x1), _homogeneous(x2)
    Ex1 = torch.einsum("sij,nj->sni", E, h1)
    Etx2 = torch.einsum("sji,nj->sni", E, h2)
    x2Ex1 = torch.einsum("ni,sni->sn", h2, Ex1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return x2Ex1 ** 2 / denom.clamp(min=1e-12)


def homography_error(H, x1, x2):
    """Squared forward transfer error [S, N]."""
    p = torch.einsum("sij,nj->sni", H, _homogeneous(x1))
    z = torch.where(p[..., 2:3].abs() < 1e-12, 1e-12, p[..., 2:3])
    return torch.sum((p[..., :2] / z - x2[None]) ** 2, -1)


# ---------------------------------------------------------------------------
# batched RANSAC
# ---------------------------------------------------------------------------

class RansacResult(NamedTuple):
    model: torch.Tensor       # [3, 3]
    inliers: torch.Tensor     # bool[N]
    n_inliers: torch.Tensor   # i64
    score: torch.Tensor       # f32 (MSAC score, lower is better)


def draw_ranks(generator: torch.Generator, valid: torch.Tensor,
               n_hyp: int, min_set: int) -> torch.Tensor:
    """i64[..., n_hyp, min_set] sample ranks for RANSAC, uniform over
    [0, number of valid rows) of each row of ``valid`` [..., N] (at
    least 1), drawn on the generator's device and returned on
    ``valid``'s, without reading the counts back."""
    raw = torch.randint(0, 2 ** 31 - 1, (*valid.shape[:-1], n_hyp, min_set),
                        generator=generator, device=generator.device)
    n = torch.sum(valid, -1).clamp(min=1)
    return raw.to(valid.device) % n[..., None, None]


def rank_rows(ranks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The row of ``valid`` [N] that holds the valid row of each rank in
    ``ranks``: ``jnp.nonzero(valid, size=N, fill_value=0)[0][ranks]``, as
    the JAX RANSACs map their sample ranks to rows."""
    N = valid.shape[0]
    pos = torch.where(valid, torch.cumsum(valid.to(torch.int64), 0) - 1, N)
    rows = torch.zeros(N + 1, dtype=torch.int64, device=valid.device).scatter(
        0, pos, torch.arange(N, device=valid.device))[:N]
    return rows[ranks]


def _ransac(ranks, x1, x2, valid, solver, err_fn, thresh):
    """Hypotheses from the valid rows of rank ``ranks`` [S, m], scored
    by MSAC over every valid row; the lowest score wins (twoview.py
    :119-135)."""
    samples = rank_rows(ranks, valid)                         # [S, m]
    models = solver(x1[samples], x2[samples])                 # [S, 3, 3]
    err = torch.where(valid[None, :], err_fn(models, x1, x2), math.inf)
    inl = err < thresh
    msac = torch.sum(torch.where(valid[None, :], err.clamp(max=thresh), 0.0),
                     1)
    best = torch.argmin(msac)
    return RansacResult(model=models[best], inliers=inl[best],
                        n_inliers=torch.sum(inl[best]), score=msac[best])


def _essential_hypotheses(x1, x2):
    return essential_project(eight_point(x1, x2))


@full_f32()
def ransac_essential(generator, x1, x2, valid, thresh=1e-4, n_hyp=512,
                     ranks=None) -> RansacResult:
    """Essential matrix RANSAC on normalized camera coordinates, then a
    refit on the inliers kept if it has at least as many.

    x1, x2: [N, 2] (padded; ``valid`` masks real rows). ``thresh`` is the
    squared Sampson distance gate in normalized coords. ``ranks``
    (i64[n_hyp, 8]) replaces the draw from ``generator``."""
    with span("ransac"):
        if ranks is None:
            ranks = draw_ranks(generator, valid, n_hyp, 8)
        res = _ransac(ranks, x1, x2, valid, _essential_hypotheses,
                      sampson_error, thresh)
        E = _refit_essential(x1, x2, res.inliers)
        inl = (sampson_error(E[None], x1, x2)[0] < thresh) & valid
        n_inl = torch.sum(inl)
        better = n_inl >= res.n_inliers
        return RansacResult(
            model=torch.where(better, E, res.model),
            inliers=torch.where(better, inl, res.inliers),
            n_inliers=torch.where(better, n_inl, res.n_inliers),
            score=res.score)


def _refit_essential(x1, x2, w):
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, torch.ones_like(u1)], -1)
    F = _null_vector(A * w.to(A.dtype)[:, None]).reshape(3, 3)
    return essential_project(F[None])[0]


@full_f32()
def ransac_homography(generator, x1, x2, valid, thresh=4.0, n_hyp=512,
                      ranks=None) -> RansacResult:
    """Homography RANSAC in pixel coordinates; thresh = squared px.
    ``ranks`` (i64[n_hyp, 4]) replaces the draw from ``generator``."""
    with span("ransac"):
        if ranks is None:
            ranks = draw_ranks(generator, valid, n_hyp, 4)
        return _ransac(ranks, x1, x2, valid, homography_dlt,
                       homography_error, thresh)


# ---------------------------------------------------------------------------
# pose recovery + triangulation
# ---------------------------------------------------------------------------

@full_f32()
def triangulate_rows(R1, t1, R2, t2, x1, x2):
    """DLT triangulation with per-row camera poses: R1/t1/R2/t2 carry a
    leading [N] axis, (R, t) map world -> camera, x: [N, 2] normalized
    coords. Returns X [N, 3] world points."""
    P1 = torch.cat([R1, t1[..., None]], -1)                   # [N, 3, 4]
    P2 = torch.cat([R2, t2[..., None]], -1)

    def rows(P, x):
        return torch.stack([x[:, 0:1] * P[:, 2] - P[:, 0],
                            x[:, 1:2] * P[:, 2] - P[:, 1]], 1)

    A = torch.cat([rows(P1, x1), rows(P2, x2)], 1)            # [N, 4, 4]
    Xh = torch.linalg.svd(A).Vh[:, -1, :]
    w = torch.where(Xh[:, 3:4].abs() < 1e-12, 1e-12, Xh[:, 3:4])
    return Xh[:, :3] / w


def triangulate(R1, t1, R2, t2, x1, x2):
    """DLT triangulation of N points seen by one camera pair: as
    :func:`triangulate_rows` with the same poses on every row."""
    n = x1.shape[0]
    return triangulate_rows(R1.expand(n, 3, 3), t1.expand(n, 3),
                            R2.expand(n, 3, 3), t2.expand(n, 3), x1, x2)


@full_f32()
def recover_pose(E, x1, x2, valid):
    """Choose the (R, t) decomposition of E with max cheirality support
    (points in front of both cameras). Returns (R, t, good_mask)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    W = _const([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E)
    Ra, Rb, t = u @ W @ vt, u @ W.T @ vt, u[:, 2]
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    zero = torch.zeros(3, dtype=E.dtype, device=E.device)
    cands = [(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)]
    masks = []
    for R2, t2 in cands:
        X = triangulate(eye, zero, R2, t2, x1, x2)
        z2 = (X @ R2.T + t2)[:, 2]
        masks.append((X[:, 2] > 0) & (z2 > 0) & valid)
    ms = torch.stack(masks)
    best = torch.argmax(torch.sum(ms, 1))
    return (torch.stack([c[0] for c in cands])[best],
            torch.stack([c[1] for c in cands])[best], ms[best])


@full_f32()
def refine_pose(R, t, x1, x2, weights, iters=10):
    """Gauss-Newton refinement of a relative pose on the essential
    manifold (5 dof: so(3) x tangent of the unit translation sphere),
    minimizing the weighted signed Sampson residual over the inlier
    set; a step is taken only where it lowers the cost. Returns (R, t),
    |t| = 1."""
    w = weights.to(x1.dtype)
    h1, h2 = _homogeneous(x1), _homogeneous(x2)
    e0, e1 = _const([1.0, 0.0, 0.0], t), _const([0.0, 1.0, 0.0], t)
    z = torch.zeros(5, dtype=x1.dtype, device=x1.device)
    ridge = 1e-9 * torch.eye(5, dtype=x1.dtype, device=x1.device)

    def unit(v):
        return v / torch.sqrt(torch.sum(v * v) + 1e-20)

    def residual(p, R, t, u, v):
        Rp = exp_so3(p[:3]) @ R
        E = hat(unit(t + p[3] * u + p[4] * v)) @ Rp
        Ex1 = h1 @ E.T
        Etx2 = h2 @ E
        num = torch.sum(h2 * Ex1, -1)
        den = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
               + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)
        return w * num / torch.sqrt(den.clamp(min=1e-12))

    for _ in range(iters):
        u = unit(torch.linalg.cross(
            t, torch.where(t[0].abs() < 0.9, e0, e1)))
        v = torch.linalg.cross(t, u)
        r0 = residual(z, R, t, u, v)
        J = jacfwd(residual)(z, R, t, u, v)                   # [N, 5]
        dp = -torch.linalg.solve(J.T @ J + ridge, J.T @ r0)
        Rn = exp_so3(dp[:3]) @ R
        tn = unit(t + dp[3] * u + dp[4] * v)
        # accept only cost-decreasing steps: the Sampson objective is
        # sign-agnostic in t, and an unguarded step on poorly
        # conditioned geometry can wander into a cheirality flip
        rn = residual(z, Rn, tn, u, v)
        better = torch.sum(rn * rn) < torch.sum(r0 * r0)
        R, t = torch.where(better, Rn, R), torch.where(better, tn, t)
    return R, t


@full_f32()
def solve_pairs_batch(generator, x1, x2, valid, thresh=1e-4, n_hyp=512,
                      ranks=None):
    """The two-view chain for B edges at once: essential RANSAC -> pose
    recovery -> essential-manifold Gauss-Newton -> cheirality
    re-decomposition -> triangulation, vmapped over a leading batch
    axis: x1/x2 [B, N, 2], valid bool[B, N]. Each edge draws its own
    ranks from ``generator`` (or takes them from ``ranks``,
    i64[B, n_hyp, 8]). Returns (R [B,3,3], t [B,3], good bool[B,N],
    X [B,N,3])."""
    if ranks is None:
        ranks = draw_ranks(generator, valid, n_hyp, 8)
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    zero = torch.zeros(3, dtype=x1.dtype, device=x1.device)

    def one(r, xa, xb, v):
        res = ransac_essential(None, xa, xb, v, thresh=thresh, ranks=r)
        w = v & res.inliers
        R2, t2, _ = recover_pose(res.model, xa, xb, w)
        R2, t2 = refine_pose(R2, t2, xa, xb, w)
        R2, t2, good = recover_pose(hat(t2) @ R2, xa, xb, w)
        return R2, t2, good, triangulate(eye, zero, R2, t2, xa, xb)

    return vmap(one)(ranks, x1, x2, valid)
