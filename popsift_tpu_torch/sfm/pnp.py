"""Absolute pose (PnP): batched DLT + RANSAC, refinement by Gauss-Newton.

Port of :mod:`popsift_tpu.sfm.pnp`. The same hypothesize-and-verify
structure as the two-view RANSAC (twoview.py): S minimal 6-point DLT
problems solved as one batched SVD, every hypothesis scored against all
correspondences in one pass. All f32, every product in full f32 whatever
torch's TF32 switch says.

Random draws, as in twoview.py: the RANSAC entries take ``generator``
where JAX takes ``key`` and draw the sample ranks with
:func:`~.twoview.draw_ranks`, or take the ranks themselves (``ranks=``);
everything after the draw depends on the ranks alone.

The sign of the DLT's null vector. :func:`pnp_dlt` takes P as the SVD
returns it, as the JAX code does (pnp.py:33-56). When the solver returns
-P, the rotation block has det < 0 and the polar step builds a rotation
from an arbitrary singular direction, which the depth flip does not undo;
such a hypothesis scores badly and loses. Solvers differ in that sign
(LAPACK through XLA and through torch on the CPU, cuSOLVER on the card),
so the same ranks can give different sets of good hypotheses and a
different winner. The refined pose and the inlier mask agree; the index
of the winning hypothesis need not. The arithmetic is kept as it is, for
parity; :func:`pose_from_projection` takes a given P so that a test can
hold the post-processing alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..utils.f32 import full_f32
from .rotation import exp_so3, log_so3
from .twoview import _null_vector, draw_ranks, rank_rows


def dlt_projection(X, x):
    """P [S, 12]: the null vector of each 6-point DLT system (the last row
    of Vh of its SVD, with the sign the solver gives). X: [S, 6, 3] world
    points; x: [S, 6, 2] normalized camera coords."""
    ones = X.new_ones(X.shape[:2])
    zeros4 = X.new_zeros(X.shape[:2] + (4,))
    Xh = torch.cat([X, ones[..., None]], -1)                  # [S, 6, 4]
    u, v = x[..., 0], x[..., 1]
    r1 = torch.cat([Xh, zeros4, -u[..., None] * Xh], -1)
    r2 = torch.cat([zeros4, Xh, -v[..., None] * Xh], -1)
    return _null_vector(torch.cat([r1, r2], 1))               # [S, 12]


def _closest_rotation(M):
    """(U diag(1, 1, det(U Vh)) Vh, singular values) of M [S, 3, 3]."""
    u, s, vt = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    return u @ (torch.stack([one, one, det], -1)[..., None] * vt), s


def pose_from_projection(P, X):
    """(R [S,3,3], t [S,3]) from DLT solutions P [S, 12] and the sample's
    world points X [S, 6, 3]: the rotation block projected onto SO(3),
    scale from its two largest singular values, the sign chosen so that
    most points lie in front (pnp.py:36-56)."""
    P = P.reshape(P.shape[0], 3, 4)
    R, sM = _closest_rotation(P[:, :, :3])
    scale = torch.mean(sM[:, :2], 1)
    scale = torch.where(scale < 1e-12, 1e-12, scale)
    t = P[:, :, 3] / scale[:, None]
    Z = torch.einsum("sij,snj->sni", R, X)[..., 2] + t[:, None, 2]
    flip = torch.sum(torch.sign(Z), 1) < 0
    R = torch.where(flip[:, None, None], -R, R)
    t = torch.where(flip[:, None], -t, t)
    return _closest_rotation(R)[0], t


@full_f32()
def pnp_dlt(X, x):
    """Batched 6-point DLT for the projection matrix.

    X: [S, 6, 3] world points; x: [S, 6, 2] normalized camera coords.
    Returns (R [S,3,3], t [S,3]) with R projected onto SO(3).
    """
    return pose_from_projection(dlt_projection(X, x), X)


@full_f32()
def reprojection_error2(R, t, X, x):
    """Squared reprojection error in normalized coords.
    R [S,3,3], t [S,3]; X [N,3]; x [N,2] -> [S,N]; inf behind the
    camera."""
    Xc = torch.einsum("sij,nj->sni", R, X) + t[:, None, :]
    z = Xc[..., 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = Xc[..., :2] / zsafe[..., None]
    err = torch.sum((proj - x[None]) ** 2, -1)
    return torch.where(z > 0, err, math.inf)


class PnPResult(NamedTuple):
    R: torch.Tensor           # [3, 3]
    t: torch.Tensor           # [3]
    inliers: torch.Tensor     # bool[N]
    n_inliers: torch.Tensor   # i64


def _ransac_pnp(ranks, X, x, valid, thresh, refine_iters) -> PnPResult:
    """PnP RANSAC of one image from the sample ranks ``ranks`` [n_hyp, 6]
    (pnp.py:83-128): MSAC picks the hypothesis, Gauss-Newton on its
    inliers refines it (rotation vector + t), and the refined pose is
    kept if it has at least as many inliers."""
    samples = rank_rows(ranks, valid)
    R, t = pnp_dlt(X[samples], x[samples])
    err = torch.where(valid[None], reprojection_error2(R, t, X, x), math.inf)
    inl = err < thresh
    msac = torch.sum(torch.where(valid[None], err.clamp(max=thresh), 0.0), 1)
    best = torch.argmin(msac)
    Rb, tb, inlb = R[best], t[best], inl[best]

    w = (inlb & valid).to(X.dtype)

    def residual(params):
        Xc = X @ exp_so3(params[:3]).T + params[3:]
        z = torch.where(Xc[:, 2].abs() < 1e-9, 1e-9, Xc[:, 2])
        proj = Xc[:, :2] / z[:, None]
        return ((proj - x) * w[:, None]).reshape(-1)

    ridge = 1e-8 * torch.eye(6, dtype=X.dtype, device=X.device)
    p = torch.cat([log_so3(Rb), tb])
    for _ in range(refine_iters):
        J = jacfwd(residual)(p)
        r = residual(p)
        # solve_ex leaves its status on the device (solve would wait
        # for it)
        p = p + torch.linalg.solve_ex(J.T @ J + ridge, -(J.T @ r)[:, None],
                                      check_errors=False).result[:, 0]
    Rf, tf = exp_so3(p[:3]), p[3:]
    inlf = (reprojection_error2(Rf[None], tf[None], X, x)[0] < thresh) & valid
    inlb = inlb & valid
    better = torch.sum(inlf) >= torch.sum(inlb)
    inl_out = torch.where(better, inlf, inlb)
    return PnPResult(R=torch.where(better, Rf, Rb),
                     t=torch.where(better, tf, tb), inliers=inl_out,
                     n_inliers=torch.sum(inl_out))


@full_f32()
def ransac_pnp(generator, X, x, valid, thresh=1e-4, n_hyp=256,
               refine_iters=10, ranks=None) -> PnPResult:
    """PnP RANSAC. X [N,3] world points, x [N,2] normalized coords,
    valid bool[N] (padding mask). thresh: squared normalized-coord gate.
    ``ranks`` (i64[n_hyp, 6]) replaces the draw from ``generator``."""
    if ranks is None:
        ranks = draw_ranks(generator, valid, n_hyp, 6)
    return _ransac_pnp(ranks, X, x, valid, thresh, refine_iters)


@full_f32()
def ransac_pnp_batch(generator, X, x, valid, thresh=1e-4, n_hyp=256,
                     refine_iters=10, ranks=None) -> PnPResult:
    """PnP RANSAC for B candidate images at once: X [B,N,3], x [B,N,2],
    valid bool[B,N] (row padding), each image with its own ranks drawn
    from ``generator`` (or given, i64[B, n_hyp, 6]). Returns a
    PnPResult with leading [B] axes; image b's row equals
    :func:`ransac_pnp` of that image with its ranks."""
    if ranks is None:
        ranks = draw_ranks(generator, valid, n_hyp, 6)
    one = lambda r, Xi, xi, vi: tuple(_ransac_pnp(r, Xi, xi, vi, thresh,
                                                  refine_iters))
    return PnPResult(*vmap(one)(ranks, X, x, valid))
