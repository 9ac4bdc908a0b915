"""One process of an N-process ``torch.distributed`` job.

    python -m popsift_tpu_torch.tools.multiproc_worker <host:port> <nprocs>
        <pid> [--device cuda|cuda:K|cpu] [--backend nccl|gloo]

The counterpart of ``scripts/multiproc_worker.py``: each process joins
the job through ``utils/device.py::init_distributed`` over
``tcp://host:port`` (process 0 listens there), a 1-D mesh spans every
process, and the workload runs the collectives the port relies on
across the process boundary: batched extraction with ``psum`` (total
keypoints), ``ppermute`` (the neighbour's descriptor sum) and
``all_gather`` (every process's sum), then one distributed bundle
adjustment step (``psum`` of the Schur reductions). Prints one line
``RESULT <checksum>`` that must be identical on every process (its
values are replicated by the collectives). ``--device cuda`` puts
process p on ``cuda:p`` and uses NCCL by default; processes that share
a GPU, or run on the CPU, need ``--backend gloo``. The spatially sharded
extraction of the JAX worker needs ``parallel/spatial.py``, not yet
ported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    """``scripts/multiproc_worker.py``'s frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 96.0 + 40.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
    for _ in range(8):
        cx = rng.uniform(0.1, 0.9) * w
        cy = rng.uniform(0.1, 0.9) * h
        s = rng.uniform(1.5, 6.0)
        img += (rng.uniform(50, 140) * rng.choice([-1.0, 1.0])
                * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.parallel.batch import make_batched_extract_fn
    from popsift_tpu_torch.parallel.launch import rank_device
    from popsift_tpu_torch.parallel.mesh import (all_gather, make_mesh,
                                                 ppermute, psum)
    from popsift_tpu_torch.sfm import ba as B
    from popsift_tpu_torch.sfm import distributed as D
    from popsift_tpu_torch.utils.device import init_distributed

    n, pid = args.nprocs, args.pid
    dev = rank_device(args.device, pid)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(coordinator=args.coordinator, num_processes=n,
                     process_id=pid, backend=args.backend)
    mesh = make_mesh(device=dev)

    # batched extraction across processes: one frame each
    h, w = 48, 64
    fn = make_batched_extract_fn(SiftConfig(octaves=2, extrema_capacity=64),
                                 h, w, mesh)
    feats, _ = fn(torch.from_numpy(_frame(h, w, seed=pid)[None]))
    total_kp = psum(feats.n_keypoints.sum(), mesh)
    desc_sum = feats.desc.sum()
    nbr = ppermute(desc_sum, mesh, [(i, (i + 1) % n) for i in range(n)])
    allsums = all_gather(desc_sum, mesh)

    # one distributed BA step
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
    _, costs = D.make_distributed_ba_fn(mesh, iters=1, cg_iters=3)(
        D.shard_of(part, mesh))

    checksum = (int(total_kp), round(float(allsums.sum()), 3),
                round(float(costs[-1]), 4))
    print(f"neighbour descriptor sum {float(nbr):.3f}", flush=True)
    print(f"RESULT {checksum}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
