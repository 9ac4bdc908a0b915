"""Distributed bundle adjustment and edge-sharded averaging over a mesh.

Port of :mod:`popsift_tpu.sfm.distributed`. Sharding layout
(landmark-parallel):

* observations are partitioned by *point*: every point's observations
  live on exactly one shard, so Hpp stays block-local (the 3x3 landmark
  blocks never cross ranks);
* camera parameters are replicated; every camera-side reduction (Hcc v,
  g_c, the Schur correction sum over points) is a :func:`psum` over the
  mesh axis: ``sfm/ba.py``'s ``reduce``, where the JAX code passes
  ``psum_axis``;
* the CG loop therefore runs identically on every rank on the
  replicated [Nc, 6] camera system; point back-substitution is local.

:func:`partition_by_point` prepares a BAProblem for a mesh (points and
their observations bucketed round-robin into equal shards, padded with
invalid observations), :func:`shard_of` takes this rank's shard, and
:func:`make_distributed_ba_fn` runs the LM loop on it. The LM loop reads
nothing back to the host: accept/reject is ``torch.where``.

The global averaging solvers (``sfm/global_sfm.py``) take ``reduce``
too; :func:`shard_edges` splits a view graph's edges over the ranks for
them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.f32 import full_f32
from ..parallel.mesh import Mesh, all_gather, axis_index, axis_size, psum
from .ba import (BAProblem, _intr_mask, intr_step, residuals, schur_cg_step,
                 schur_dense_step)


def partition_by_point(p: BAProblem, n_shards: int):
    """Reorder/pad a BAProblem so points and observations split evenly
    into ``n_shards`` contiguous, point-aligned blocks. Host-side; returns
    (the problem with a leading [n_shards] axis on points and
    observations, on ``p``'s device, ``new_index``: each point's row in
    the flattened [n_shards * np_per] points)."""
    dev = p.cams.device
    cams = p.cams.cpu().numpy()
    pts = p.points.cpu().numpy()
    oc = p.obs_cam.cpu().numpy()
    op = p.obs_pt.cpu().numpy()
    uv = p.obs_uv.cpu().numpy()
    ov = p.obs_valid.cpu().numpy()
    Np = pts.shape[0]

    # round-robin points over shards, padding EVERY shard to np_per
    # (with Np not divisible by n_shards, shards get floor or ceil
    # counts — each must be padded individually so the per-shard local
    # indices line up with the [n_shards, np_per] point layout)
    np_per = -(-Np // n_shards) if Np else 1
    pt_shard = np.arange(Np) % n_shards
    pts2 = np.zeros((n_shards, np_per, 3), pts.dtype)
    new_index = np.empty(Np, np.int64)
    for s in range(n_shards):
        ids = np.nonzero(pt_shard == s)[0]
        pts2[s, :len(ids)] = pts[ids]
        new_index[ids] = s * np_per + np.arange(len(ids))

    # group observations by point shard
    obs_shard = pt_shard[op]
    grouped = [np.nonzero((obs_shard == s) & ov)[0]
               for s in range(n_shards)]
    No_per = max(max(len(r) for r in grouped), 1)

    n_oc = np.zeros((n_shards, No_per), np.int64)
    n_op = np.zeros((n_shards, No_per), np.int64)
    n_uv = np.zeros((n_shards, No_per, 2), uv.dtype)
    n_ov = np.zeros((n_shards, No_per), bool)
    for s, rows in enumerate(grouped):
        k = len(rows)
        n_oc[s, :k] = oc[rows]
        # local point index within the shard
        n_op[s, :k] = new_index[op[rows]] - s * np_per
        n_uv[s, :k] = uv[rows]
        n_ov[s, :k] = True

    t = lambda a: torch.from_numpy(a).to(dev)
    return BAProblem(
        cams=t(cams), points=t(pts2), intr=p.intr, obs_cam=t(n_oc),
        obs_pt=t(n_op), obs_uv=t(n_uv), obs_valid=t(n_ov),
        cam_fixed=p.cam_fixed), new_index


def shard_of(p: BAProblem, mesh: Mesh,
             axis_name: str | None = None) -> BAProblem:
    """This rank's shard of a :func:`partition_by_point` problem (one
    shard a rank of the axis), on the mesh's device: the cameras, the
    intrinsics and ``cam_fixed`` whole, its points and observations."""
    if p.points.shape[0] != axis_size(mesh, axis_name):
        raise ValueError(f"{p.points.shape[0]} shards for "
                         f"{axis_size(mesh, axis_name)} ranks")
    me = axis_index(mesh, axis_name)
    own = lambda a: a[me].to(mesh.device)
    whole = lambda a: a.to(mesh.device)
    return BAProblem(cams=whole(p.cams), points=own(p.points),
                     intr=whole(p.intr), obs_cam=own(p.obs_cam),
                     obs_pt=own(p.obs_pt), obs_uv=own(p.obs_uv),
                     obs_valid=own(p.obs_valid),
                     cam_fixed=whole(p.cam_fixed))


def gather_points(points: torch.Tensor, mesh: Mesh, new_index,
                  axis_name: str | None = None) -> torch.Tensor:
    """Every rank's refined points [np_per, 3] back in the original point
    order (``new_index`` from :func:`partition_by_point`), on every rank."""
    flat = all_gather(points, mesh, axis_name=axis_name).reshape(-1, 3)
    return flat[torch.as_tensor(new_index, device=flat.device)]


def make_distributed_ba_fn(mesh: Mesh, axis_name: str | None = None,
                           iters: int = 8, cg_iters: int = 20,
                           lam0: float = 1e-3, dense: bool = False,
                           opt_intr: bool = False, intr_mask=None):
    """The LM bundle adjustment of one rank's shard (:func:`shard_of`):
    fn(shard) -> (the refined shard, costs [iters]), the cameras, the
    intrinsics and the costs equal on every rank.

    With ``dense`` the reduced camera system is built locally per shard
    and reduced once per GN step ([6Nc, 6Nc]) instead of two [Nc, 6]
    reductions per CG iteration — fewer, fatter collectives, and an
    exact solve (``ba.py::schur_dense_step``). ``opt_intr`` + ``dense``
    jointly solves the [6Nc+4] augmented reduced system (one extra [6Nc,
    4] + [4, 4] reduction); on the CG path it alternates a
    shared-intrinsics GN step per LM iteration (one [4, 4] + [4]
    reduction, ``ba.py::intr_step``)."""
    def reduce(x):
        return psum(x, mesh, axis_name)

    def total_cost(p):
        r = residuals(p)
        return reduce(torch.sum(r * r))

    @full_f32()
    def run(prob: BAProblem):
        mask4 = _intr_mask(intr_mask, prob.intr) if opt_intr else None
        lam = prob.cams.new_full((), lam0)
        costs = []
        for _ in range(iters):
            di = None
            if dense and opt_intr:
                dc, dp, di, cost = schur_dense_step(
                    prob, lam, reduce=reduce, opt_intr=True,
                    intr_mask=mask4)
            elif dense:
                dc, dp, cost = schur_dense_step(prob, lam, reduce=reduce)
            else:
                dc, dp, cost = schur_cg_step(prob, lam, cg_iters=cg_iters,
                                             reduce=reduce)
            new = prob._replace(cams=prob.cams + dc,
                                points=prob.points + dp)
            if di is not None:
                new = new._replace(intr=prob.intr + di)
            new_cost = total_cost(new)
            ok = new_cost < cost       # NaN steps are rejected too
            prob = prob._replace(
                cams=torch.where(ok, new.cams, prob.cams),
                points=torch.where(ok, new.points, prob.points),
                intr=torch.where(ok, new.intr, prob.intr))
            cost = torch.where(ok, new_cost, cost)
            if opt_intr and not dense:
                di = intr_step(prob, lam, reduce=reduce, intr_mask=mask4)
                cand = prob._replace(intr=prob.intr + di)
                c_cost = total_cost(cand)
                ok_i = c_cost < cost
                prob = prob._replace(
                    intr=torch.where(ok_i, cand.intr, prob.intr))
                cost = torch.where(ok_i, c_cost, cost)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
            costs.append(cost)
        return prob, torch.stack(costs)

    return run


def _neutral(shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """A finite payload for a padded edge: the identity of a [..., 3, 3]
    rotation, else the unit vector e0 (a direction)."""
    out = like.new_zeros(shape)
    if len(shape) >= 2 and shape[-1] == shape[-2]:
        out[...] = torch.eye(shape[-1], dtype=like.dtype, device=like.device)
    else:
        out[..., 0] = 1
    return out


def shard_edges(ei, ej, payload, valid, mesh: Mesh,
                axis_name: str | None = None) -> tuple:
    """This rank's share of a view graph's edges for the averaging solvers
    run with ``reduce=psum``: the edges padded to a multiple of the axis
    size with masked (0, 0) self-loops (a neutral payload, ``valid``
    False), then the rank's contiguous slice, on the mesh's device.
    ``valid`` None means every edge counts. Returns (ei, ej, payload,
    valid)."""
    n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    E = ei.shape[0]
    pad = -(-E // n) * n - E
    if valid is None:
        valid = torch.ones(E, dtype=torch.bool, device=ei.device)
    ei = torch.cat([ei, ei.new_zeros(pad)])
    ej = torch.cat([ej, ej.new_zeros(pad)])
    payload = torch.cat([payload,
                         _neutral((pad, *payload.shape[1:]), payload)])
    valid = torch.cat([valid.bool(), valid.new_zeros(pad, dtype=torch.bool)])
    per = (E + pad) // n
    part = slice(me * per, (me + 1) * per)
    return tuple(a[part].to(mesh.device) for a in (ei, ej, payload, valid))
