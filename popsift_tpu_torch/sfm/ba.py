"""Bundle adjustment: Levenberg-Marquardt with Schur-complement CG.

Port of :mod:`popsift_tpu.sfm.ba`; the design is the JAX package's:

* residuals/Jacobians are *batched over observations* — one vmapped
  pinhole projection, Jacobians by forward-mode autodiff
  (``torch.func.vmap`` of ``torch.func.jacfwd`` over the gathered camera
  and point of each observation). No sparse matrix is ever assembled.
* the reduced camera system  S = Hcc - Hcp Hpp^-1 Hpc  is applied
  *matrix-free* inside CG: each application is segment sums over
  observations (``index_add_``) plus batched 3x3 solves for the point
  blocks; or, where the dense coupling fits memory, formed explicitly
  with one large f32 matrix product and solved directly.
* block-Jacobi preconditioner from the Hcc diagonal blocks.

``reduce`` stands where the JAX code takes ``psum_axis``: a callable
applied to exactly the tensors the JAX code ``psum``s (observations
sharded by point across processes, camera-side sums reduced), or None.

The LM loop (:func:`bundle_adjust`) is a Python loop over ``iters``
whose accept/reject and damping update are ``torch.where`` on the
device: nothing in it reads a value back to the host, as JAX's jitted
scan does not. The linear solves use ``solve_ex`` without its error
check for that reason. On CUDA the segment sums add in no fixed order,
so two runs can differ in the last bits, and a near tie in the accept
test can go either way.

Camera model: world->camera rigid transform (rotvec[3], t[3]) with shared
fixed intrinsics (fx, fy, cx, cy). Camera parameter block size 6.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..utils.device import resolve_device
from ..utils.f32 import full_f32
from .rotation import exp_so3

CAM_DIM = 6

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


class BAProblem(NamedTuple):
    cams: torch.Tensor       # f32[Nc, 6]  (rotvec, t)
    points: torch.Tensor     # f32[Np, 3]
    intr: torch.Tensor       # f32[4] fx fy cx cy
    obs_cam: torch.Tensor    # i64[No]
    obs_pt: torch.Tensor     # i64[No]
    obs_uv: torch.Tensor     # f32[No, 2]
    obs_valid: torch.Tensor  # bool[No]
    cam_fixed: torch.Tensor  # bool[Nc] gauge fixing (e.g. first camera)


_DTYPES = dict(cams=np.float32, points=np.float32, intr=np.float32,
               obs_cam=np.int64, obs_pt=np.int64, obs_uv=np.float32,
               obs_valid=np.bool_, cam_fixed=np.bool_)


def problem_from_numpy(fields, device="cuda") -> BAProblem:
    """The port's BAProblem from a mapping of its field names to numpy
    arrays (the JAX package's ``BAProblem`` fields as numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in prob._asdict().items()}``), on
    ``device``; observation indices become i64."""
    dev = resolve_device(device)
    return BAProblem(**{
        name: torch.from_numpy(np.ascontiguousarray(fields[name], dt)).to(dev)
        for name, dt in _DTYPES.items()})


def project(cam, X, intr):
    """Pinhole projection of one point through one camera."""
    R = exp_so3(cam[:3])
    Xc = R @ X + cam[3:6]
    z = torch.where(Xc[2].abs() < 1e-9, 1e-9, Xc[2])
    return torch.stack([intr[0] * Xc[0] / z + intr[2],
                        intr[1] * Xc[1] / z + intr[3]])


def _gathered(p: BAProblem):
    """Each observation's camera [No, 6] and point [No, 3]."""
    return p.cams[p.obs_cam], p.points[p.obs_pt]


@full_f32()
def residuals(p: BAProblem):
    """r [No, 2] = predicted - observed, zeroed for invalid obs."""
    cams, X = _gathered(p)
    r = vmap(project, in_dims=(0, 0, None))(cams, X, p.intr) - p.obs_uv
    return torch.where(p.obs_valid[:, None], r, 0.0)


def robust_cost(r, huber_delta=None):
    """Total cost of residuals [No, 2]: plain squared L2, or the Huber
    loss on the per-observation norm when ``huber_delta`` is set."""
    if huber_delta is None:
        return torch.sum(r * r)
    n2 = torch.sum(r * r, 1)
    n = torch.sqrt(n2 + 1e-20)
    d = float(np.float32(huber_delta))
    return torch.sum(torch.where(n <= d, n2, 2.0 * d * n - d * d))


def _huber_sw(r, huber_delta):
    """sqrt IRLS weights [No, 1] for the Huber loss: w = min(1, d/|r|).
    Applied to both r and J, one observation's influence on the normal
    equations saturates at the inlier scale — a single gross outlier
    (e.g. a mismatched track) can no longer dominate the f32 system."""
    n = torch.sqrt(torch.sum(r * r, 1) + 1e-20)
    d = n.new_full((), float(np.float32(huber_delta)))
    return torch.sqrt((d / n).clamp(max=1.0))[:, None]


@full_f32()
def _jacobians(p: BAProblem):
    """Per-observation Jacobians Jc [No,2,6], Jp [No,2,3] (fwd autodiff)."""
    cams, X = _gathered(p)
    Jc, Jp = vmap(jacfwd(project, argnums=(0, 1)),
                  in_dims=(0, 0, None))(cams, X, p.intr)
    m = p.obs_valid[:, None, None]
    # gauge: fixed cameras contribute no camera gradient
    free = ~p.cam_fixed[p.obs_cam]
    Jc = torch.where(m & free[:, None, None], Jc, 0.0)
    Jp = torch.where(m, Jp, 0.0)
    return Jc, Jp


def _seg_sum(values, idx, num):
    return values.new_zeros((num,) + values.shape[1:]).index_add_(
        0, idx, values)


def _reduced(x, reduce: Reduce):
    return x if reduce is None else reduce(x)


def _adjugate33(H):
    """(adjugate [..., 3, 3], determinant clamped away from 0) of SPD H."""
    a00, a01, a02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    a11, a12, a22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    det0 = a11 * a22 - a12 * a12
    det1 = a12 * a02 - a01 * a22
    det2 = a01 * a12 - a11 * a02
    det3 = a00 * a22 - a02 * a02
    det4 = a01 * a02 - a00 * a12
    det5 = a00 * a11 - a01 * a01
    det = a00 * det0 + a01 * det1 + a02 * det2
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    return torch.stack([
        torch.stack([det0, det1, det2], -1),
        torch.stack([det1, det3, det4], -1),
        torch.stack([det2, det4, det5], -1)], -2), det


def _inv33(H):
    """Batched SPD 3x3 inverse via adjugate."""
    adj, det = _adjugate33(H)
    return adj / det[..., None, None]


def _solve33(H, b):
    """Batched SPD 3x3 solve via adjugate (same shape as s_solve.h)."""
    return torch.einsum("...ij,...j->...i", _inv33(H), b)


def _solve(A, b):
    """A^-1 b for b [..., n]: LU, its status left on the device."""
    return torch.linalg.solve_ex(A, b[..., None],
                                 check_errors=False).result[..., 0]


def _intr_mask(intr_mask, like):
    """f32[4] on ``like``'s device: ones, or ``intr_mask`` (a tensor or
    four numbers, filled on the device without a host copy)."""
    if intr_mask is None:
        return like.new_ones(4)
    if isinstance(intr_mask, torch.Tensor):
        return intr_mask.to(like.device, torch.float32)
    return torch.stack([like.new_full((), float(v)) for v in intr_mask])


class _SchurOps(NamedTuple):
    Jc: torch.Tensor
    Jp: torch.Tensor
    Hpp_inv_chol: torch.Tensor  # damped Hpp (not factored; solved per use)
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    Nc: int
    Np: int
    lam: torch.Tensor
    Hcc_diag: torch.Tensor      # [Nc, 6, 6] damped block diagonal


def _build_schur(p: BAProblem, lam, reduce: Reduce = None, sw=None):
    Jc, Jp = _jacobians(p)
    if sw is not None:               # IRLS sqrt weights [No, 1]
        Jc = Jc * sw[:, :, None]
        Jp = Jp * sw[:, :, None]
    Nc = p.cams.shape[0]
    Np = p.points.shape[0]
    Hpp = _seg_sum(torch.einsum("oki,okj->oij", Jp, Jp), p.obs_pt, Np)
    Hcc = _seg_sum(torch.einsum("oki,okj->oij", Jc, Jc), p.obs_cam, Nc)
    Hcc = _reduced(Hcc, reduce)
    eye3 = torch.eye(3, dtype=Jp.dtype, device=Jp.device)
    eye6 = torch.eye(6, dtype=Jc.dtype, device=Jc.device)
    Hpp = Hpp + lam * eye3[None]
    Hcc = Hcc + lam * eye6[None]
    return _SchurOps(Jc=Jc, Jp=Jp, Hpp_inv_chol=Hpp,
                     obs_cam=p.obs_cam, obs_pt=p.obs_pt,
                     Nc=Nc, Np=Np, lam=lam, Hcc_diag=Hcc)


def _apply_S(ops: _SchurOps, v, reduce: Reduce = None):
    """S v for the reduced camera system, matrix-free."""
    vc = v[ops.obs_cam]                                # [No, 6]
    Jv = torch.einsum("oki,oi->ok", ops.Jc, vc)        # [No, 2]
    # Hcc v (local) — block diagonal, but computed via obs to keep the
    # sharded path identical: a = seg_cam(Jc^T Jv) (+reduce)
    a = _seg_sum(torch.einsum("oki,ok->oi", ops.Jc, Jv), ops.obs_cam, ops.Nc)
    b = _seg_sum(torch.einsum("oki,ok->oi", ops.Jp, Jv), ops.obs_pt, ops.Np)
    c = _solve33(ops.Hpp_inv_chol, b)                  # Hpp^-1 Hpc v
    Jpc = torch.einsum("oki,oi->ok", ops.Jp, c[ops.obs_pt])
    d = _seg_sum(torch.einsum("oki,ok->oi", ops.Jc, Jpc), ops.obs_cam,
                 ops.Nc)
    return _reduced(a - d, reduce) + ops.lam * v


def _precond(ops: _SchurOps, r):
    """Block-Jacobi: solve the damped 6x6 camera diagonal blocks."""
    eye = torch.eye(CAM_DIM, dtype=r.dtype, device=r.device) * 1e-8
    return _solve(ops.Hcc_diag + eye[None], r)


@full_f32()
def schur_dense_step(p: BAProblem, lam, reduce: Reduce = None,
                     huber_delta=None, opt_intr: bool = False,
                     intr_mask=None):
    """One damped Gauss-Newton step via an EXPLICIT dense reduced camera
    system.

    The camera-point coupling blocks are aggregated into a dense U
    [Np, Nc, 6, 3] with a single combined-index segment sum, and the
    Schur correction

        B = U Hpp^-1 U^T            (a (6Nc, 3Np) x (3Np, 6Nc) matmul)

    is one f32 matrix product (TF32 off: the JAX code asks for
    ``Precision.HIGHEST``). The reduced system S = Hcc + lam I - B
    (6Nc x 6Nc) is then solved directly — symmetric Jacobi scaling
    followed by an LU solve; exact, no CG tolerance. (LU rather than
    Cholesky: S is PSD only up to f32 roundoff.) Feasible whenever the
    dense U fits (Np*Nc*72 bytes; ~288 MB for 100 cameras and 40,000
    points) — ``bundle_adjust`` picks this path automatically and falls
    back to CG otherwise.

    With ``reduce``, Hcc, B, the camera gradient and its correction are
    reduced once per step, where the JAX code psums them.

    ``opt_intr``: JOINTLY solve for the shared intrinsics block by
    augmenting the reduced camera system to [6Nc+4, 6Nc+4]. Returns
    (dc, dp, di, cost); ``intr_mask`` (f32[4], 1 = optimize) freezes
    components (e.g. [1,1,0,0] = focal only). Without it returns
    (dc, dp, cost).
    """
    Nc = p.cams.shape[0]
    Np = p.points.shape[0]
    r = residuals(p)
    cost = _reduced(robust_cost(r, huber_delta), reduce)
    Jc, Jp = _jacobians(p)
    if huber_delta is not None:      # IRLS: scale r and J by sqrt(w)
        sw = _huber_sw(r, huber_delta)
        r = r * sw
        Jc = Jc * sw[:, :, None]
        Jp = Jp * sw[:, :, None]

    eye3 = torch.eye(3, dtype=Jp.dtype, device=Jp.device)
    Hpp = _seg_sum(torch.einsum("oki,okj->oij", Jp, Jp), p.obs_pt, Np)
    Hcc = _seg_sum(torch.einsum("oki,okj->oij", Jc, Jc), p.obs_cam, Nc)
    Hcc = _reduced(Hcc, reduce)
    Hpp = Hpp + lam * eye3[None]
    Hpp_inv = _inv33(Hpp)                               # [Np, 3, 3]

    # dense camera-point coupling via ONE combined-index segment sum
    W = torch.einsum("oki,okj->oij", Jc, Jp)            # [No, 6, 3]
    comb = p.obs_pt * Nc + p.obs_cam
    U = _seg_sum(W.reshape(-1, 18), comb, Np * Nc).reshape(Np, Nc, 6, 3)

    A = torch.einsum("pcik,pkl->pcil", U, Hpp_inv)      # U Hpp^-1
    # B[(c,i),(d,j)] = sum_{p,k} A[p,c,i,k] U[p,d,j,k] as one matmul
    A2 = A.permute(1, 2, 0, 3).reshape(Nc * 6, Np * 3)
    U2 = U.permute(1, 2, 0, 3).reshape(Nc * 6, Np * 3)
    B = A2 @ U2.T                                       # [6Nc, 6Nc]

    g_c = _reduced(_seg_sum(torch.einsum("oki,ok->oi", Jc, r), p.obs_cam,
                            Nc), reduce)
    g_p = _seg_sum(torch.einsum("oki,ok->oi", Jp, r), p.obs_pt, Np)
    corr = torch.einsum("pcik,pk->ci", A, g_p)          # U Hpp^-1 g_p
    # one [6Nc, 6Nc] + one [Nc, 6] reduction per GN step
    B = _reduced(B, reduce)
    corr = _reduced(corr, reduce)
    rhs = -(g_c - corr)                                 # [Nc, 6]

    S = -B
    # the diagonal blocks of S, [6, 6, Nc], += Hcc
    torch.diagonal(S.view(Nc, 6, Nc, 6), dim1=0, dim2=2).add_(
        Hcc.permute(1, 2, 0))
    S = S + lam * torch.eye(Nc * 6, dtype=B.dtype, device=B.device)

    if opt_intr:
        # augment the reduced system with the shared 4-dim intrinsics
        # block: S_aug = [[S, Sci], [Sci^T, Sii]] with the point
        # couplings eliminated through the same Hpp^-1
        mask4 = _intr_mask(intr_mask, p.intr)
        Ji = _intr_jacobian(p)
        if huber_delta is not None:
            Ji = Ji * sw[:, :, None]
        Ji = Ji * mask4[None, None, :]       # frozen comps: zero columns
        Hii = torch.einsum("oki,okj->ij", Ji, Ji)
        Hci = _seg_sum(torch.einsum("oki,okj->oij", Jc, Ji),
                       p.obs_cam, Nc)                   # [Nc, 6, 4]
        Vi = _seg_sum(torch.einsum("oki,okj->oij", Ji, Jp),
                      p.obs_pt, Np)                     # [Np, 4, 3]
        g_i = torch.einsum("oki,ok->i", Ji, r)
        Ai = torch.einsum("pik,pkl->pil", Vi, Hpp_inv)  # Vi Hpp^-1
        B_ci = torch.einsum("pcik,pjk->cij", A, Vi)     # [Nc, 6, 4]
        B_ii = torch.einsum("pik,pjk->ij", Ai, Vi)
        corr_i = torch.einsum("pik,pk->i", Ai, g_p)
        Hii, Hci, B_ci, B_ii, g_i, corr_i = (
            _reduced(x, reduce) for x in (Hii, Hci, B_ci, B_ii, g_i, corr_i))
        Sci = (Hci - B_ci).reshape(Nc * 6, 4)
        eye4 = torch.eye(4, dtype=B.dtype, device=B.device)
        Sii = Hii - B_ii + lam * eye4 + torch.diag(1.0 - mask4)
        S = torch.cat([torch.cat([S, Sci], 1), torch.cat([Sci.T, Sii], 1)])
        rhs = torch.cat([rhs.reshape(-1), -(g_i - corr_i)])

    # symmetric Jacobi scaling before the LU solve: S is PSD only up to
    # f32 roundoff (entries span ~1e7 : lam), and an unscaled
    # factorization can go singular
    d = torch.rsqrt(torch.diagonal(S).clamp(min=1e-12))
    Ss = S * d[:, None] * d[None, :]
    x = _solve(Ss, rhs.reshape(-1) * d) * d
    dc = x[:Nc * 6].reshape(Nc, 6)
    dc = torch.where(p.cam_fixed[:, None], 0.0, dc)

    # back-substitute point updates: dp = Hpp^-1 (-g_p - Hpc dc [- Hpi di])
    Jdc = torch.einsum("oki,oi->ok", Jc, dc[p.obs_cam])
    if opt_intr:
        di = x[Nc * 6:] * mask4
        Jdc = Jdc + torch.einsum("oki,i->ok", Ji, di)
    hpc = _seg_sum(torch.einsum("oki,ok->oi", Jp, Jdc), p.obs_pt, Np)
    dp = _solve33(Hpp, -g_p - hpc)
    if opt_intr:
        return dc, dp, di, cost
    return dc, dp, cost


@full_f32()
def schur_cg_step(p: BAProblem, lam, cg_iters: int = 25,
                  reduce: Reduce = None, huber_delta=None):
    """One damped Gauss-Newton step. Returns (d_cams, d_points, cost)."""
    r = residuals(p)
    cost = _reduced(robust_cost(r, huber_delta), reduce)
    sw = None
    if huber_delta is not None:
        sw = _huber_sw(r, huber_delta)
        r = r * sw
    ops = _build_schur(p, lam, reduce=reduce, sw=sw)

    g_c = _reduced(_seg_sum(torch.einsum("oki,ok->oi", ops.Jc, r),
                            p.obs_cam, ops.Nc), reduce)
    g_p = _seg_sum(torch.einsum("oki,ok->oi", ops.Jp, r), p.obs_pt, ops.Np)

    hp = _solve33(ops.Hpp_inv_chol, g_p)
    Jphp = torch.einsum("oki,oi->ok", ops.Jp, hp[p.obs_pt])
    rhs_corr = _reduced(_seg_sum(torch.einsum("oki,ok->oi", ops.Jc, Jphp),
                                 p.obs_cam, ops.Nc), reduce)
    rhs = -(g_c - rhs_corr)                            # [Nc, 6]

    # preconditioned CG on S x = rhs
    x = torch.zeros_like(rhs)
    res = rhs - _apply_S(ops, x, reduce)
    z = _precond(ops, res)
    d = z
    rz = torch.sum(res * z)
    for _ in range(cg_iters):
        Sd = _apply_S(ops, d, reduce)
        denom = torch.sum(d * Sd)
        # f32 roundoff can make S indefinite near convergence: a
        # non-positive curvature direction would blow alpha up to inf
        # and poison the whole step with NaN — freeze instead
        live = denom > 1e-20
        alpha = torch.where(live, rz / torch.where(live, denom, 1.0), 0.0)
        x = x + alpha * d
        res = res - alpha * Sd
        z = _precond(ops, res)
        rz_new = torch.sum(res * z)
        beta = torch.where(live, rz_new / rz.clamp(min=1e-20), 0.0)
        d = z + beta * d
        rz = torch.where(live, rz_new, rz)
    dc = torch.where(p.cam_fixed[:, None], 0.0, x)

    # back-substitute point updates: dp = Hpp^-1 (-g_p - Hpc dc)
    Jdc = torch.einsum("oki,oi->ok", ops.Jc, dc[p.obs_cam])
    hpc = _seg_sum(torch.einsum("oki,ok->oi", ops.Jp, Jdc), p.obs_pt, ops.Np)
    dp = _solve33(ops.Hpp_inv_chol, -g_p - hpc)
    return dc, dp, cost


@full_f32()
def _intr_jacobian(p: BAProblem):
    """Per-observation Jacobian wrt the shared intrinsics Ji [No,2,4]
    (forward autodiff through the pinhole projection), masked like the
    camera/point Jacobians."""
    cams, X = _gathered(p)
    Ji = vmap(jacfwd(project, argnums=2), in_dims=(0, 0, None))(
        cams, X, p.intr)
    return torch.where(p.obs_valid[:, None, None], Ji, 0.0)


@full_f32()
def intr_step(p: BAProblem, lam, huber_delta=None, reduce: Reduce = None,
              intr_mask=None):
    """One damped GN step on the SHARED intrinsics block (fx fy cx cy)
    with cameras/points held fixed — the intrinsics half of a
    block-coordinate LM iteration (``bundle_adjust(opt_intr=True)`` on
    the CG path). One [4, 4] solve; with ``reduce``, H and g are reduced
    first. ``intr_mask`` (f32[4], 1 = optimize) freezes components, e.g.
    [1, 1, 0, 0] to refine focal only.
    """
    r = residuals(p)
    Ji = _intr_jacobian(p)
    if huber_delta is not None:
        sw = _huber_sw(r, huber_delta)
        r = r * sw
        Ji = Ji * sw[:, :, None]
    H = _reduced(torch.einsum("oki,okj->ij", Ji, Ji), reduce)
    g = _reduced(torch.einsum("oki,ok->i", Ji, r), reduce)
    mask = _intr_mask(intr_mask, p.intr)
    # frozen components: zero rows/cols + unit diagonal
    H = H * mask[:, None] * mask[None, :]
    eye4 = torch.eye(4, dtype=H.dtype, device=H.device)
    H = H + (lam + 1e-8) * eye4 + torch.diag(1.0 - mask)
    di = -_solve(H, g * mask)
    return di * mask


def dense_schur_feasible(n_cams: int, n_points: int,
                         budget_bytes: int = 1 << 31) -> bool:
    """Whether the explicit dense-U Schur path fits the memory budget."""
    return n_cams * 6 <= 4096 and n_points * n_cams * 72 <= budget_bytes


@full_f32()
def bundle_adjust(p: BAProblem, iters: int = 10, cg_iters: int = 25,
                  lam0: float = 1e-3, dense: bool | None = None,
                  huber_delta: float | None = None,
                  opt_intr: bool = False, intr_mask=None):
    """Levenberg-Marquardt loop (fixed iteration count).

    Accept/reject with damping update: classic LM without host sync.
    ``dense`` selects the dense-Schur direct solve
    (:func:`schur_dense_step`) over matrix-free CG; by default it is on
    whenever the dense coupling matrix fits memory (from the shapes
    alone). ``huber_delta`` switches the objective to the Huber loss on
    the per-observation residual norm (IRLS reweighting each GN step).
    ``opt_intr`` solves the shared intrinsics jointly on the dense path
    and alternates an :func:`intr_step`, with its own accept/reject,
    with every camera/point step on the CG path; ``intr_mask`` (f32[4],
    1 = optimize) restricts the refined components (e.g.
    ``[1, 1, 0, 0]`` for focal only). Returns (problem, costs f32[iters]).
    """
    if dense is None:
        dense = dense_schur_feasible(int(p.cams.shape[0]),
                                     int(p.points.shape[0]))
    mask4 = _intr_mask(intr_mask, p.intr) if opt_intr else None
    prob = p
    lam = p.cams.new_full((), lam0)
    costs = []
    for _ in range(iters):
        if dense and opt_intr:
            # joint augmented-Schur step: cams + points + intrinsics in
            # one solve (the alternating intr_step stalls on the
            # focal<->depth coupled direction)
            dc, dp, di, cost = schur_dense_step(
                prob, lam, huber_delta=huber_delta, opt_intr=True,
                intr_mask=mask4)
        elif dense:
            dc, dp, cost = schur_dense_step(prob, lam,
                                            huber_delta=huber_delta)
            di = None
        else:
            dc, dp, cost = schur_cg_step(prob, lam, cg_iters=cg_iters,
                                         huber_delta=huber_delta)
            di = None
        new = prob._replace(cams=prob.cams + dc, points=prob.points + dp)
        if di is not None:
            new = new._replace(intr=prob.intr + di)
        new_cost = robust_cost(residuals(new), huber_delta)
        ok = new_cost < cost           # NaN steps are rejected too
        # accept/reject the whole step
        prob = prob._replace(cams=torch.where(ok, new.cams, prob.cams),
                             points=torch.where(ok, new.points, prob.points),
                             intr=torch.where(ok, new.intr, prob.intr))
        cost = torch.where(ok, new_cost, cost)
        if opt_intr and not dense:
            # CG path: alternate a shared-intrinsics GN step (approximate
            # but memory-free; the dense path does the joint solve)
            di = intr_step(prob, lam, huber_delta=huber_delta,
                           intr_mask=mask4)
            cand = prob._replace(intr=prob.intr + di)
            c_cost = robust_cost(residuals(cand), huber_delta)
            ok_i = c_cost < cost
            prob = prob._replace(intr=torch.where(ok_i, cand.intr, prob.intr))
            cost = torch.where(ok_i, c_cost, cost)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
        costs.append(cost)
    return prob, torch.stack(costs)
