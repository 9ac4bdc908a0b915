"""Global structure-from-motion: rotation + translation averaging.

Port of :mod:`popsift_tpu.sfm.global_sfm`. Instead of registering
cameras one at a time (incremental.py), ALL pairwise relative poses are
estimated first (two-view RANSAC per view-graph edge), then global camera
rotations and positions are solved in two batched least-squares
problems, followed by triangulation and robust global BA.

Method: IRLS rotation averaging in the so(3) tangent (the Chatterjee-
Govindu scheme: per-edge residual v_e = log(R_j^T R_rel R_i), linear
model v_e + b_i - b_j, weighted graph-Laplacian normal equations)
followed by least-squares translation averaging over the edge direction
projectors (I - d d^T), with a linear scale constraint pinning the sum
of projected baselines.

The JAX solvers are jitted ``lax.scan`` / ``fori_loop`` programs; here
each is a Python loop over its rounds whose annealed Huber threshold
(``0.7 ** it``) is a Python float and whose weights stay on the device,
so a solve reads nothing back until its caller does. The linear solves
use ``solve_ex`` without its error check for that reason. ``reduce``
stands where the JAX code takes ``psum_axis``: a callable applied to
exactly the tensors the JAX code ``psum``s, or None. Every product runs
in full f32 (``utils/f32.py::full_f32``). The solvers work in the dtype
of their inputs (f64 in the tests that hold them to an exact solve).

The gauge is pinned by a 1e6 diagonal plus 1e-6 I, as in the JAX code,
so the f32 systems are badly conditioned; two solvers agree to the
extent their LU factorizations round alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.f32 import full_f32
from .ba import Reduce, _reduced, _solve, _solve33
from .rotation import exp_so3, log_so3
from .twoview import solve_pairs_batch, triangulate

# hypotheses of each edge's essential RANSAC (solve_pairs_batch's default)
EDGE_HYPOTHESES = 512
EDGE_CHUNK = 32


def _annealed(huber_delta: float, it: int) -> float:
    """The IRLS threshold of round ``it``: start permissive so the graph
    stays effectively connected, tighten as the estimate converges."""
    return max(huber_delta * 0.7 ** it, huber_delta / 10)


def _huber_weights(delta: float, res: torch.Tensor) -> torch.Tensor:
    """min(1, delta / res), dividing by the residual as the JAX code does."""
    return torch.clamp(res.new_full((), delta) / res, max=1.0)


@full_f32()
def rotation_averaging(n: int, ei, ej, R_rel, iters: int = 20,
                       huber_delta: float = 0.1, valid=None,
                       reduce: Reduce = None):
    """Solve global rotations from pairwise relatives.

    ei, ej: integer [E] edge endpoints; R_rel: [E, 3, 3] with the
    convention R_rel[e] ~= R_j @ R_i^T (world->cam rotations). Returns
    (R [n, 3, 3] with R[0] = I (gauge), costs [iters]).

    ``valid`` masks padded edges. ``reduce`` (edges sharded across
    processes) is applied to the Laplacian [n, n] and the gradient
    [n, 3] of each round; the solve itself is replicated (tiny).

    Each IRLS round: per-edge LOCAL-frame tangent residual
    v_e = log(R_j^T R_rel R_i) (a right-multiplicative update
    R_i <- R_i exp(b_i) linearizes to v + b_i - b_j), Huber weights on
    ||v_e||, and one dense graph-Laplacian solve L b = -g."""
    ii, jj = ei.long(), ej.long()
    eye_n = torch.eye(n, dtype=R_rel.dtype, device=R_rel.device)
    R = torch.eye(3, dtype=R_rel.dtype, device=R_rel.device).repeat(n, 1, 1)
    costs = []
    for it in range(iters):
        M = torch.einsum("eba,ebc,ecd->ead", R[jj], R_rel, R[ii])
        v = log_so3(M)                                   # [E, 3]
        vn = torch.sqrt(torch.sum(v * v, -1) + 1e-20)
        w = _huber_weights(_annealed(huber_delta, it), vn)
        if valid is not None:
            w = w * valid.to(w.dtype)
        # weighted Laplacian L and gradient g (model v + b_i - b_j)
        L = R_rel.new_zeros((n, n))
        L.index_put_((ii, jj), -w, accumulate=True)
        L.index_put_((jj, ii), -w, accumulate=True)
        L.index_put_((ii, ii), w, accumulate=True)
        L.index_put_((jj, jj), w, accumulate=True)
        g = R_rel.new_zeros((n, 3))
        g.index_add_(0, ii, w[:, None] * v).index_add_(0, jj, -w[:, None] * v)
        L, g = _reduced(L, reduce), _reduced(g, reduce)
        # gauge: pin camera 0 (a large diagonal instead of row removal)
        L[0, 0] += 1e6
        b = torch.linalg.solve_ex(L + 1e-6 * eye_n, -g,
                                  check_errors=False).result  # [n, 3]
        R = torch.einsum("nab,nbc->nac", R, exp_so3(b))
        costs.append(torch.sum(w * vn * vn))
    # re-gauge exactly: R <- R R_0^T so camera 0 is the identity
    return torch.einsum("nab,cb->nac", R, R[0]), torch.stack(costs)


def _edge_geometry(d_world, valid):
    """Unit directions d [E, 3], projectors P = I - d d^T [E, 3, 3] and
    the edge mask as weights."""
    d = d_world / torch.linalg.vector_norm(
        d_world, dim=1, keepdim=True).clamp(min=1e-12)
    eye3 = torch.eye(3, dtype=d.dtype, device=d.device)
    P = eye3[None] - torch.einsum("ea,eb->eab", d, d)
    vmask = (d.new_ones(d.shape[0]) if valid is None
             else valid.to(d.dtype))
    return d, P, vmask


def _reweight(C, ii, jj, d, w, huber_delta: float, it: int):
    """One IRLS reweighting of the translation solvers: weights from the
    ANGULAR residual |perp| / |C_j - C_i| (an absolute perpendicular
    residual would down-weight the long-baseline edges that constrain
    the solution best). Returns (new weights, the round's cost)."""
    r = C[jj] - C[ii]
    blen = torch.linalg.vector_norm(r, dim=1).clamp(min=1e-6)
    perp = r - d * torch.sum(d * r, -1, keepdim=True)
    ang = torch.sqrt(torch.sum(perp * perp, -1) + 1e-20) / blen
    return (_huber_weights(_annealed(huber_delta, it), ang),
            torch.sum(w * ang * ang))


def _scale_row(n, ii, jj, d, w):
    """The scale constraint's row s [n, 3]: sum_e w_e d_e . (C_j - C_i)."""
    sw = w[:, None] * d
    return d.new_zeros((n, 3)).index_add_(0, jj, sw).index_add_(0, ii, -sw)


@full_f32()
def translation_averaging(n: int, ei, ej, d_world, iters: int = 12,
                          huber_delta: float = 0.1, valid=None,
                          reduce: Reduce = None):
    """Solve camera centers C [n, 3] from edge directions.

    d_world: [E, 3] unit direction of (C_j - C_i) in world coordinates.
    Minimizes sum_e w_e ||(I - d d^T)(C_j - C_i)||^2 with C_0 = 0
    (gauge) and the scale pinned by the weighted linear constraint
    sum_e w_e d_e . (C_j - C_i) = sum_e w_e (penalty row), with the
    annealed-Huber IRLS schedule of rotation averaging. One dense
    [3n, 3n] solve per round. Returns (C, costs [iters]).

    The JAX code accumulates H as [n, 3, n, 3] with ``H.at[ii, :, ii,
    :]``; here H is laid out [n, n, 3, 3] (each edge's 3 x 3 block at
    (i, j)) and permuted to [3n, 3n] after the sums."""
    ii, jj = ei.long(), ej.long()
    d, P, vmask = _edge_geometry(d_world, valid)
    eye = torch.eye(3 * n, dtype=d.dtype, device=d.device)

    def solve(w):
        w = w * vmask
        Pw = P * w[:, None, None]
        H = d.new_zeros((n, n, 3, 3))
        H.index_put_((ii, ii), Pw, accumulate=True)
        H.index_put_((jj, jj), Pw, accumulate=True)
        H.index_put_((ii, jj), -Pw, accumulate=True)
        H.index_put_((jj, ii), -Pw, accumulate=True)
        H = H.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
        # scale penalty: mu (sum_e w_e d.(C_j - C_i) - sum_e w_e)^2
        s = _scale_row(n, ii, jj, d, w).reshape(-1)
        w_tot = torch.sum(w)
        H, s, w_tot = (_reduced(x, reduce) for x in (H, s, w_tot))
        H = H + torch.outer(s, s)                        # mu = 1
        rhs = w_tot * s
        # gauge: pin C_0
        idx = torch.arange(3, device=d.device)
        H[idx, idx] += 1e6
        return _solve(H + 1e-6 * eye, rhs).reshape(n, 3)

    w = vmask * 0.0 + 1.0
    costs = []
    for it in range(iters):
        w, cost = _reweight(solve(w), ii, jj, d, w, huber_delta, it)
        costs.append(cost)
    costs = torch.stack(costs) if costs else d.new_zeros(0)
    return solve(w), costs


@full_f32()
def translation_averaging_cg(n: int, ei, ej, d_world, iters: int = 12,
                             cg_iters: int = 200,
                             huber_delta: float = 0.1, valid=None,
                             reduce: Reduce = None):
    """Matrix-free CG form of :func:`translation_averaging`.

    The dense form assembles a [3n, 3n] system: with points as graph
    nodes that is infeasible at tens of thousands of tracks. Here the
    normal-equations operator H v is applied edge-wise (the gather +
    segment-sum structure of ba.py::_apply_S): per CG iteration two row
    gathers, one batched 3x3 product and one scatter-add, O(E) memory.
    Preconditioner: the 3x3 block diagonal of the edge Laplacian, solved
    with the adjugate (ba._solve33).

    Same objective, gauge (C_0 pinned), scale constraint and IRLS
    schedule as the dense solver. ``reduce`` is applied to each
    iteration's scatter-add and, once a solve, to (s, w_tot, block
    diagonal), where the JAX code psums them."""
    ii, jj = ei.long(), ej.long()
    d, P, vmask = _edge_geometry(d_world, valid)
    eye3 = torch.eye(3, dtype=d.dtype, device=d.device)

    def solve(w):
        w = w * vmask
        Pw = P * w[:, None, None]
        s = _scale_row(n, ii, jj, d, w)
        w_tot = torch.sum(w)
        D = d.new_zeros((n, 3, 3)).index_add_(0, ii, Pw).index_add_(0, jj, Pw)
        s, w_tot, D = (_reduced(x, reduce) for x in (s, w_tot, D))
        D = D + torch.einsum("na,nb->nab", s, s) + 1e-6 * eye3[None]
        D[0] += 1e6 * eye3

        def Hv(v):
            q = torch.einsum("eab,eb->ea", Pw, v[ii] - v[jj])
            out = d.new_zeros((n, 3)).index_add_(0, ii, q)
            out = out.index_add_(0, jj, -q)
            out = _reduced(out, reduce)
            out = out + s * torch.sum(s * v)
            out[0] += 1e6 * v[0]
            return out + 1e-6 * v

        rhs = w_tot * s
        x = d.new_zeros((n, 3))
        r = rhs - Hv(x)
        z = _solve33(D, r)
        p = z
        rz = torch.sum(r * z)
        for _ in range(cg_iters):
            Hp = Hv(p)
            denom = torch.sum(p * Hp)
            live = denom > 1e-20
            alpha = torch.where(live, rz / torch.where(live, denom, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Hp
            z = _solve33(D, r)
            rz_new = torch.sum(r * z)
            beta = torch.where(live, rz_new / rz.clamp(min=1e-20), 0.0)
            p = z + beta * p
            rz = torch.where(live, rz_new, rz)
        return x

    w = vmask * 0.0 + 1.0
    costs = []
    for it in range(iters):
        w, cost = _reweight(solve(w), ii, jj, d, w, huber_delta, it)
        costs.append(cost)
    costs = torch.stack(costs) if costs else d.new_zeros(0)
    return solve(w), costs


def global_sfm(tracks, intr, min_covis: int = 30, max_edges: int = 400,
               seed: int = 0, ba_iters: int = 15,
               huber_delta: float | None = 2.0, device="cuda"):
    """End-to-end global SfM over a track set, on ``device`` (``"cuda"``
    by default; asking for it without a card raises).

    1. view-graph edges: image pairs with >= min_covis shared tracks
       (top ``max_edges`` by co-visibility);
    2. per-edge two-view solve (essential RANSAC + manifold GN polish),
       ``EDGE_CHUNK`` edges per device call, each chunk's ranks drawn
       through the driver's ``_draw``;
    3. rotation averaging -> global R; translation averaging over the
       edge baseline directions and the camera-point bearings -> camera
       centers (dense up to 1500 nodes, CG above);
    4. triangulation of every track from its two widest-baseline
       observations + robust (Huber) global bundle adjustment.

    Returns an IncrementalSfM whose reconstruction is fully populated —
    checkpointing, evaluation, and further BA reuse the same machinery.
    """
    import scipy.sparse as sp

    from .incremental import IncrementalSfM

    drv = IncrementalSfM(tracks, intr, seed=seed, device=device)
    images = drv.images
    n = len(images)

    rows = np.concatenate(
        [np.full(len(drv._img_tracks[img]), k, np.int64)
         for k, img in enumerate(images)])
    cols = np.concatenate([drv._img_tracks[img] for img in images])
    M = sp.csr_matrix((np.ones(len(rows), np.int32), (rows, cols)),
                      shape=(n, drv._n_tracks))
    C = (M @ M.T).toarray()
    C[np.tril_indices(n)] = 0
    cand = np.argwhere(C >= min_covis)
    order = np.argsort(-C[cand[:, 0], cand[:, 1]])
    cand = cand[order[:max_edges]]

    # Per-edge two-view solves, batched EDGE_CHUNK edges per device call.
    # Host-side acceptance matches _solve_pair: >= 8 shared tracks, and at
    # least one triangulated point passing the cheirality + reprojection
    # gate.
    obs = []
    for i, j in cand:
        common = drv._common_tracks(images[i], images[j])
        if len(common) < 8:
            obs.append(None)
            continue
        obs.append((drv.rec.normalized(drv._obs_uv(images[i], common)),
                    drv.rec.normalized(drv._obs_uv(images[j], common))))
    ei, ej, Rr, tw = [], [], [], []
    live = [k for k, o in enumerate(obs) if o is not None]
    chunk = EDGE_CHUNK
    for c0 in range(0, len(live), chunk):
        ck = live[c0:c0 + chunk]
        nmax = max(len(obs[k][0]) for k in ck)
        cap = max(64, 1 << (nmax - 1).bit_length())
        xa = np.zeros((chunk, cap, 2), np.float32)
        xb = np.zeros((chunk, cap, 2), np.float32)
        vp = np.zeros((chunk, cap), bool)
        for r, k in enumerate(ck):
            m = len(obs[k][0])
            xa[r, :m] = obs[k][0]
            xb[r, :m] = obs[k][1]
            vp[r, :m] = True
        valid = drv._dev(vp)
        R, t, good, X = solve_pairs_batch(
            None, drv._dev(xa), drv._dev(xb), valid,
            thresh=drv.reproj_thresh,
            ranks=drv._draw(valid, EDGE_HYPOTHESES, 8))
        R, t = R.cpu().numpy(), t.cpu().numpy()
        good, X = good.cpu().numpy(), X.cpu().numpy()
        for r, k in enumerate(ck):
            m = len(obs[k][0])
            g = good[r, :m] & drv._accept_points(
                X[r, :m].astype(np.float32),
                [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                  xa[r, :m]), (R[r], t[r], xb[r, :m])])
            if not g.any():
                continue
            i, j = cand[k]
            ei.append(i)
            ej.append(j)
            Rr.append(R[r])           # R_rel = R_j R_i^T convention
            tw.append(t[r])
    if len(ei) < n - 1:
        raise ValueError("view graph too sparse for global SfM")
    ei = np.asarray(ei, np.int32)
    ej = np.asarray(ej, np.int32)
    Rr = np.stack(Rr).astype(np.float32)
    tw = np.stack(tw).astype(np.float32)

    R, _ = rotation_averaging(n, drv._dev(ei), drv._dev(ej), drv._dev(Rr))
    R = R.cpu().numpy()
    # edge baseline direction in world coords: C_j - C_i ~ -R_j^T t_rel
    # with t_rel re-expressed against the AVERAGED global rotations
    d = -np.einsum("eba,eb->ea", R[ej], tw)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

    # Camera-point BEARING constraints: with rotations known, every
    # observation fixes the world direction camera -> point,
    # u = R_i^T [x, y, 1]^. Camera-camera directions alone are
    # DEGENERATE for near-collinear trajectories (a straight-line
    # sequence satisfies every (I - dd^T)(C_j - C_i) = 0 at ANY
    # per-segment spacing); points off the path restore the spacing.
    # Points join the same solve as extra graph nodes.
    track_ids = np.unique(np.asarray(tracks.track_id, np.int64))
    tr_pos = {int(t): n + k for k, t in enumerate(track_ids)}
    bi, bj, bu = [], [], []
    for k, img in enumerate(images):
        trs = drv._img_tracks[img]
        uv = drv.rec.normalized(
            np.asarray(tracks.uv)[drv._img_rows_sorted[img]])
        rays = np.concatenate(
            [uv, np.ones((len(uv), 1), np.float32)], axis=1)
        u = rays @ R[k]                       # R_i^T applied row-wise
        u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True),
                           1e-12)
        bi.extend([k] * len(trs))
        bj.extend(tr_pos[int(t)] for t in trs)
        bu.append(u)
    ntot = n + len(track_ids)
    ei_all = drv._dev(np.concatenate([ei, np.asarray(bi, np.int32)]))
    ej_all = drv._dev(np.concatenate([ej, np.asarray(bj, np.int32)]))
    d_all = drv._dev(np.concatenate([d, np.concatenate(bu)])
                     .astype(np.float32))
    # dense [3*ntot]^2 Laplacian solve up to 1.5k nodes; above that the
    # matrix-free CG form (O(E) memory) takes over
    if ntot <= 1500:
        Cc, _ = translation_averaging(ntot, ei_all, ej_all, d_all)
    else:
        Cc, _ = translation_averaging_cg(ntot, ei_all, ej_all, d_all)
    Cc = Cc.cpu().numpy()[:n]

    for k, img in enumerate(images):
        drv.rec.cam_R[img] = R[k].astype(np.float32)
        drv.rec.cam_t[img] = (-R[k] @ Cc[k]).astype(np.float32)
        drv._mark_registered(img)

    # round 1: loose acceptance (averaged positions are pre-BA
    # estimates; the standard 3x gate would reject most structure and
    # leave BA under-constrained) -> robust BA -> re-triangulate the
    # remaining tracks at the standard gate -> final BA
    _triangulate_all(drv, mult=400.0)
    drv.global_ba(iters=ba_iters, huber_delta=huber_delta)
    _triangulate_all(drv, mult=9.0)
    drv.global_ba(iters=ba_iters, huber_delta=huber_delta)
    return drv


def _triangulate_all(drv, mult: float = 9.0):
    """Triangulate every track from its two widest-baseline registered
    observations, one device call per (first, last) image pair, gated
    by the incremental engine's acceptance test (``mult`` =
    squared-distance gate multiplier). The per-track loop and the
    per-pair calls are the JAX code's."""
    from .incremental import _pad

    img_of_pos = {k: img for k, img in enumerate(drv.images)}
    # only registered observers have poses — an incremental run can
    # finish with unregistered images and their observations must not
    # feed triangulation
    reg_pos = np.array([img_of_pos[k] in drv.rec.registered
                        for k in range(len(drv.images))], bool)
    # per-track observing image positions from the CSR index
    t1, t2, tid = [], [], []
    for tr in range(drv._n_tracks):
        span = drv._tr_img_pos[drv._tr_ptr[tr]:drv._tr_ptr[tr + 1]]
        span = span[reg_pos[span]]
        if len(span) < 2:
            continue
        # widest baseline pair among (up to) the first/last observers
        a, b = int(span[0]), int(span[-1])
        if a == b:
            continue
        t1.append(a)
        t2.append(b)
        tid.append(tr)
    if not tid:
        return
    t1 = np.asarray(t1)
    t2 = np.asarray(t2)
    tid = np.asarray(tid, np.int64)

    # group by (a, b) image pair for batched triangulation
    keys = t1.astype(np.int64) * len(drv.images) + t2
    order = np.argsort(keys, kind="stable")
    t1, t2, tid, keys = t1[order], t2[order], tid[order], keys[order]
    starts = np.flatnonzero(np.r_[True, np.diff(keys) != 0])
    ends = np.r_[starts[1:], len(keys)]
    for s, e in zip(starts, ends):
        a, b = img_of_pos[int(t1[s])], img_of_pos[int(t2[s])]
        trs = tid[s:e]
        xa = drv.rec.normalized(drv._obs_uv(a, trs))
        xb = drv.rec.normalized(drv._obs_uv(b, trs))
        N = len(trs)
        cap = max(16, 1 << (N - 1).bit_length())
        X = triangulate(
            drv._dev(drv.rec.cam_R[a]), drv._dev(drv.rec.cam_t[a]),
            drv._dev(drv.rec.cam_R[b]), drv._dev(drv.rec.cam_t[b]),
            drv._dev(_pad(xa, cap)), drv._dev(_pad(xb, cap))
        ).cpu().numpy()[:N]
        keep = drv._accept_points(
            X, [(drv.rec.cam_R[a], drv.rec.cam_t[a], xa),
                (drv.rec.cam_R[b], drv.rec.cam_t[b], xb)], mult=mult)
        drv._add_points(trs[keep], X[keep])
