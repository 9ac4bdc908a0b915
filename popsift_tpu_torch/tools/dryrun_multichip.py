"""One step of each multi-rank path of the port, at tiny shapes.

    python -m popsift_tpu_torch.tools.dryrun_multichip [--world-size N]
        [--device cuda|cuda:K|cpu] [--backend nccl|gloo]

The counterpart of ``__graft_entry__.py::dryrun_multichip`` on
``torch.distributed``: N ranks (``parallel/launch.py::spawn``), a 1-D
mesh over them, and

1. data-parallel batched extraction (one 48 x 64 frame a rank) with the
   ring descriptor matching (``ppermute``);
3. one distributed Schur-complement bundle-adjustment step with ``psum``
   camera reductions (landmark-sharded observations);
5. all-pairs systolic-ring descriptor matching;
6. edge-sharded rotation averaging (one ``psum`` of the Laplacian normal
   equations per IRLS round);
7. edge-sharded matrix-free translation averaging (a ``psum`` per CG
   iteration).

Items 2, 2b and 4 of the JAX dryrun (the spatially sharded pyramid and
extraction, and DP x SP on a 2-D mesh) need ``parallel/spatial.py``,
which is not yet ported; the report says so. ``--device cuda`` puts rank
r on ``cuda:r`` and runs on NCCL by default; ranks that share one GPU
(``--device cuda:0``) or run on the CPU need ``--backend gloo``. Exits
non-zero when a rank fails or a check does not hold.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

NOT_PORTED = ("2. spatially sharded pyramid", "2b. sharded extraction",
              "4. DP x SP extraction")


def _demo_image(h, w, seed=0):
    """``__graft_entry__.py::_demo_image``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 96.0 + 40.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
    for _ in range(16):
        cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
        s = rng.uniform(1.5, min(h, w) / 12.0)
        a = rng.uniform(50, 140) * rng.choice([-1.0, 1.0])
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img += rng.normal(0, 1.5, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def dryrun_rank(device) -> dict:
    """Items 1, 3, 5, 6 and 7 on this rank; returns its readings."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.parallel.batch import (make_allpairs_match_fn,
                                                  make_batched_extract_fn)
    from popsift_tpu_torch.parallel.mesh import axis_index, make_mesh, psum
    from popsift_tpu_torch.sfm import ba as B
    from popsift_tpu_torch.sfm import distributed as D
    from popsift_tpu_torch.sfm import global_sfm as G
    from popsift_tpu_torch.sfm.rotation import exp_so3

    mesh = make_mesh(device=device)
    n, me = mesh.shape["dp"], axis_index(mesh)
    reduce = lambda x: psum(x, mesh)

    # 1. DP extraction + ring matching
    cfg = SiftConfig(octaves=2, extrema_capacity=64)
    h, w = 48, 64
    fn = make_batched_extract_fn(cfg, h, w, mesh, match_pairs=True)
    out, match = fn(torch.from_numpy(_demo_image(h, w, seed=me)[None]))
    n_kp = int(reduce(out.n_keypoints.sum()))

    # 3. distributed BA step
    rng = np.random.default_rng(0)
    n_pts, n_cams, n_obs = 4 * n, 3, 8 * n
    fields = dict(
        cams=rng.normal(0, 0.1, (n_cams, 6)),
        points=rng.uniform([-1, -1, 4], [1, 1, 6], (n_pts, 3)),
        intr=np.array([100.0, 100.0, 32.0, 24.0]),
        obs_cam=rng.integers(0, n_cams, n_obs),
        obs_pt=rng.integers(0, n_pts, n_obs),
        obs_uv=rng.normal(32, 8, (n_obs, 2)),
        obs_valid=np.ones(n_obs, bool),
        cam_fixed=np.array([True, False, False]))
    part, _ = D.partition_by_point(B.problem_from_numpy(fields, "cpu"), n)
    ba = D.make_distributed_ba_fn(mesh, iters=1, cg_iters=3)
    _, costs = ba(D.shard_of(part, mesh))

    # 5. all-pairs systolic ring matching
    rngm = np.random.default_rng(2)
    descm = rngm.normal(size=(n, 16, 128)).astype(np.float32)
    descm /= np.linalg.norm(descm, axis=-1, keepdims=True)
    ap = make_allpairs_match_fn(mesh, tile=16)(
        torch.from_numpy(descm[me:me + 1]).to(device),
        torch.ones((1, 16), dtype=torch.bool, device=device))

    # 6. edge-sharded rotation averaging over a chain of 6 cameras
    n_rot = 6
    rngr = np.random.default_rng(4)
    R_gt = exp_so3(torch.from_numpy(
        rngr.normal(0, 0.5, (n_rot, 3)).astype(np.float32))).numpy()
    eir = np.arange(n_rot - 1)
    ejr = eir + 1
    R_rel = np.einsum("eab,ecb->eac", R_gt[ejr], R_gt[eir]).astype(
        np.float32)
    a, b, R, v = D.shard_edges(torch.from_numpy(eir), torch.from_numpy(ejr),
                               torch.from_numpy(R_rel), None, mesh)
    R_avg, _ = G.rotation_averaging(n_rot, a, b, R, valid=v, reduce=reduce)
    rot_err = float(np.abs(R_avg.cpu().numpy() - np.einsum(
        "nab,cb->nac", R_gt, R_gt[0])).max())

    # 7. edge-sharded matrix-free translation averaging
    C_gt = rngr.uniform(-4, 4, (n_rot, 3)).astype(np.float32)
    ti = np.concatenate([np.arange(n_rot - 1), np.arange(n_rot - 2)])
    tj = np.concatenate([np.arange(1, n_rot), np.arange(2, n_rot)])
    dt = C_gt[tj] - C_gt[ti]
    dt = (dt / np.linalg.norm(dt, axis=1, keepdims=True)).astype(np.float32)
    a, b, d, v = D.shard_edges(torch.from_numpy(ti), torch.from_numpy(tj),
                               torch.from_numpy(dt), None, mesh)
    C_avg, _ = G.translation_averaging_cg(n_rot, a, b, d, iters=2,
                                          cg_iters=12, valid=v,
                                          reduce=reduce)
    return dict(n_keypoints=n_kp, matching=match is not None,
                ring_rows=int(match.accept.shape[-1]),
                allpairs=tuple(ap.accept.shape), ba_cost=float(costs[-1]),
                rot_err=rot_err,
                tr_finite=bool(torch.isfinite(C_avg).all()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r), cuda:K (every rank on "
                         "cuda:K; needs --backend gloo) or cpu")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    from popsift_tpu_torch.parallel.launch import spawn
    from popsift_tpu_torch.tools import dryrun_multichip as this
    res = spawn(this.dryrun_rank, args.world_size, args.backend, args.device)
    r = res[0]
    same = all(x == r for x in res)
    print(f"dryrun_multichip: {args.world_size} ranks ({args.backend}, "
          f"{args.device}), {r['n_keypoints']} keypoints, matching "
          f"ok={r['matching']} ({r['ring_rows']} rows a pair), all-pairs "
          f"ring {r['allpairs']} a rank, distributed BA cost "
          f"{r['ba_cost']:.3f}, distributed rotation averaging err "
          f"{r['rot_err']:.2e}, distributed translation averaging "
          f"finite={r['tr_finite']}, ranks agree={same}; not yet ported "
          f"(parallel/spatial.py): {', '.join(NOT_PORTED)}", flush=True)
    ok = (same and r["tr_finite"] and r["matching"] and r["n_keypoints"] > 0
          and np.isfinite(r["ba_cost"]) and r["rot_err"] < 1e-3)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
