"""Rank bodies for ``parallel/launch.py::spawn``: what each rank of the
multi-rank tests runs (``tests/test_torch_mesh.py``,
``test_torch_parallel.py``, ``test_torch_sfm_distributed.py``).

Each function is called as ``fn(device, *args)`` on every rank of a job,
builds its mesh over the whole job and returns numpy arrays (picklable,
off the card), so the caller can compare them with single-process runs
and with the JAX package. Nothing here imports jax.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import SiftConfig
from ..parallel import mesh as M
from ..parallel.batch import (gather_features, make_allpairs_match_fn,
                              make_batched_extract_fn)


def as_numpy(tree):
    """Tensors of a NamedTuple, dict or list as numpy arrays (bool kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return {k: as_numpy(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_numpy(v) for v in tree)
    return tree


@contextlib.contextmanager
def no_transport():
    """Any call into the backend's collectives raises inside the block."""
    names = ("all_reduce", "all_gather", "batch_isend_irecv",
             "all_gather_into_tensor", "broadcast", "send", "recv")
    saved = {n: getattr(dist, n) for n in names}

    def refuse(*a, **k):
        raise AssertionError("a collective was called at axis size 1")
    for n in names:
        setattr(dist, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def collectives(device):
    """psum, all_gather (stacked, tiled, along axis 1, of bools) and
    ppermute (right, left, one pair) on the job's 1-D mesh of this
    rank's x = arange(6).reshape(2, 3) + 10 * rank; with 4 ranks also the
    2 x 2 mesh's subgroups; at 1 rank the identities, under
    :func:`no_transport`."""
    from ..utils.device import init_distributed
    mesh = M.make_mesh(device=device)
    me, n = M.axis_index(mesh), M.axis_size(mesh)
    x = torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3) \
        + 10 * me
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    with (no_transport() if n == 1 else contextlib.nullcontext()):
        out = dict(
            me=me, n=n,
            psum=M.psum(x, mesh), psum_i64=M.psum(x.long(), mesh),
            gather=M.all_gather(x, mesh),
            gather_tiled=M.all_gather(x, mesh, tiled=True),
            gather_axis1=M.all_gather(x, mesh, axis=1, tiled=True),
            gather_bool=M.all_gather(x > 12, mesh),
            right=M.ppermute(x, mesh, right),
            left=M.ppermute(x, mesh, left),
            one_pair=M.ppermute(x, mesh, [(0, n - 1)]))
        if n == 1:
            out["same_objects"] = (M.psum(x, mesh) is x
                                   and M.all_gather(x, mesh, tiled=True) is x
                                   and M.ppermute(x, mesh, [(0, 0)]) is x)
    out["init_again"] = init_distributed(backend=dist.get_backend())
    out["report"] = M.device_report()
    if dist.get_world_size() == 4:
        m2 = M.make_mesh_2d(2, 2, device=device)
        out["coords_2d"] = (m2.coords["dp"], m2.coords["mp"])
        out["dp_sum"] = M.psum(x, m2, "dp")
        out["mp_sum"] = M.psum(x, m2, "mp")
        out["mp_gather"] = M.all_gather(x, m2, axis_name="mp")
    return as_numpy(out)


def fail_on(device, bad_rank: int):
    """Rank ``bad_rank`` raises; the others wait in a collective for it."""
    mesh = M.make_mesh(device=device)
    if M.axis_index(mesh) == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    M.psum(torch.ones(1, device=device), mesh)
    return True


def hang(device, seconds: float):
    """Outlive the launcher's timeout."""
    time.sleep(seconds)
    return True


def _block(a: np.ndarray, mesh) -> np.ndarray:
    n, me = M.axis_size(mesh), M.axis_index(mesh)
    b = a.shape[0] // n
    return a[me * b:(me + 1) * b]


def parallel_suite(device, frames: np.ndarray, rolled: np.ndarray,
                   cfg_kw: dict, desc: np.ndarray, valid: np.ndarray,
                   tile: int):
    """Data-parallel extraction of ``frames`` [B, H, W] (each rank its
    B/n), the ring matches of ``rolled``, and all-pairs matching of
    (``desc`` [N, C, 128], ``valid``) in blocks of N/n, each gathered to
    the whole batch."""
    mesh = M.make_mesh(device=device)
    cfg = SiftConfig(**cfg_kw)
    h, w = frames.shape[1:]
    fn = make_batched_extract_fn(cfg, h, w, mesh)
    feats, none = fn(torch.from_numpy(_block(frames, mesh)))
    ring_fn = make_batched_extract_fn(cfg, h, w, mesh, match_pairs=True)
    rfeats, ring = ring_fn(torch.from_numpy(_block(rolled, mesh)))
    ap_fn = make_allpairs_match_fn(mesh, tile=tile)
    ap = ap_fn(torch.from_numpy(_block(desc, mesh)).to(device),
               torch.from_numpy(_block(valid, mesh)).to(device))
    return as_numpy(dict(
        no_matches=none is None,
        local_keypoints=feats.n_keypoints,
        feats=gather_features(feats, mesh),
        ring_feats=gather_features(rfeats, mesh),
        ring=gather_features(ring, mesh),
        allpairs=gather_features(ap, mesh)))


def _problem(fields: dict, device, f64: bool = False):
    from ..sfm import ba as B
    p = B.problem_from_numpy(fields, device)
    if f64:
        p = p._replace(**{k: getattr(p, k).double()
                          for k in ("cams", "points", "intr", "obs_uv")})
    return p


def ba_cases(device, cases: dict, step_fields: dict):
    """Distributed bundle adjustment of each case ``name -> (fields,
    make_distributed_ba_fn keywords)``, and the first GN steps (CG and
    dense) of ``step_fields`` in f64, all in the original point order."""
    from ..sfm import ba as B
    from ..sfm import distributed as D
    mesh = M.make_mesh(device=device)
    n = M.axis_size(mesh)
    out = {}
    for name, (fields, kw) in cases.items():
        part, idx = D.partition_by_point(_problem(fields, "cpu"), n)
        prob, costs = D.make_distributed_ba_fn(mesh, **kw)(
            D.shard_of(part, mesh))
        out[name] = as_numpy(dict(
            cams=prob.cams, intr=prob.intr, costs=costs,
            points=D.gather_points(prob.points, mesh, idx)))
    part, idx = D.partition_by_point(_problem(step_fields, "cpu", True), n)
    shard = D.shard_of(part, mesh)
    lam = shard.cams.new_full((), 1e-3)
    reduce = lambda x: M.psum(x, mesh)
    steps = {"cg": B.schur_cg_step(shard, lam, cg_iters=25, reduce=reduce),
             "dense": B.schur_dense_step(shard, lam, reduce=reduce)}
    for kind, (dc, dp, cost) in steps.items():
        out[f"step_{kind}"] = as_numpy(dict(
            dc=dc, dp=D.gather_points(dp, mesh, idx), cost=cost))
    return out


def averaging(device, n: int, ei: np.ndarray, ej: np.ndarray,
              R_rel: np.ndarray, d: np.ndarray, cg_kw: dict):
    """Edge-sharded rotation averaging of (ei, ej, R_rel) and translation
    averaging (dense and CG) of (ei, ej, d) on ``n`` nodes, each rank
    assembling its share of the edges and ``psum`` forming the system."""
    from ..sfm import distributed as D
    from ..sfm import global_sfm as G
    mesh = M.make_mesh(device=device)
    reduce = lambda x: M.psum(x, mesh)
    t = torch.from_numpy
    a, b, R, v = D.shard_edges(t(ei), t(ej), t(R_rel), None, mesh)
    rot = G.rotation_averaging(n, a, b, R, valid=v, reduce=reduce)[0]
    a, b, dd, v = D.shard_edges(t(ei), t(ej), t(d), None, mesh)
    tr = G.translation_averaging(n, a, b, dd, valid=v, reduce=reduce)[0]
    tr_cg = G.translation_averaging_cg(n, a, b, dd, valid=v, reduce=reduce,
                                       **cg_kw)[0]
    return as_numpy(dict(rot=rot, tr=tr, tr_cg=tr_cg))


def sfm_suite(device, cases: dict, step_fields: dict, graph: tuple,
              cg_kw: dict):
    """:func:`ba_cases` and :func:`averaging` of ``graph`` (n, ei, ej,
    R_rel, d) in one job."""
    return {"ba": ba_cases(device, cases, step_fields),
            "avg": averaging(device, *graph, cg_kw)}
