"""End-to-end images -> model run of the port at the user surface.

The port's copy of scripts/e2e_proof.py: it renders an orbital
fly-around of a 3-D Gaussian-blob scene (``render_sequence``, held to
the original's source by tests/test_torch_imports.py; ground-truth
camera centers known) and drives the port's three CLIs on it, each in
its own process with ``--device``:

  popsift-demo  (``cli.demo``) on frame 0: extraction to a feature file;
  popsift-match (``cli.match --geom essential``) on frames 0-1;
  popsift-sfm   (``cli.sfm --retrieval 8 --refine --export-colmap
                 --export-ply``) on all frames;

then the ATE of the registered cameras against the ground truth after a
similarity alignment (``sfm/evaluate.py::ate_rmse``). It prints one JSON
line (wall time per CLI, counts, registered cameras, BA costs, ATE, the
device's name) and writes it to ``--out`` when given.

Usage, from the repository root:

    python -m popsift_tpu_torch.tools.e2e_proof [n_frames h w]
        [--device cuda] [--seed 0] [--work DIR] [--out FILE]

``n_frames h w`` default to 100 240 320 (the scene of the JAX package's
E2E artifact); ``--device`` defaults to ``cuda`` and raises without a
card; ``--work`` (frames, features, the model) defaults to a new
temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def render_sequence(n_frames=100, h=240, w=320, n_blobs=420, seed=3):
    """Render an orbital fly-around of a 3-D Gaussian-blob scene.

    Every image feature comes from a projected 3-D blob (no
    image-plane texture — that would break multi-view consistency), so
    SIFT keypoints are genuine projections of static structure and the
    recovered trajectory is comparable to ground truth.
    """
    rng = np.random.default_rng(seed)
    # scene: blob cloud in a [-2,2]^2 x [4,8] box in world coords plus
    # a loose ground carpet below, intensities signed around mid-gray
    pts = np.concatenate([
        rng.uniform([-2.2, -1.6, 4.0], [2.2, 1.6, 8.0], (n_blobs * 2 // 3, 3)),
        rng.uniform([-3.0, 1.2, 3.5], [3.0, 1.8, 8.5], (n_blobs // 3, 3)),
    ])
    amp = rng.uniform(55, 130, len(pts)) * rng.choice([-1.0, 1.0], len(pts))
    size = rng.uniform(0.035, 0.16, len(pts))      # world-space radius

    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    centers = []
    frames = []
    look = np.array([0.0, 0.0, 6.0])               # scene centroid
    for f in range(n_frames):
        ang = np.deg2rad(-24.0 + 48.0 * f / max(n_frames - 1, 1))
        c = np.array([3.6 * np.sin(ang), 0.35 * np.sin(3 * ang),
                      6.0 - 5.6 * np.cos(ang)])
        fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R = np.stack([right, up, fwd])             # world->cam rows
        t = -R @ c
        centers.append(c)

        pc = pts @ R.T + t                         # camera coords
        z = pc[:, 2]
        vis = z > 0.5
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        r_px = fx * size / z                       # projected radius
        img = np.full((h, w), 96.0)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for i in np.nonzero(vis)[0]:
            ri = r_px[i]
            if u[i] < -4 * ri or u[i] > w + 4 * ri:
                continue
            if v[i] < -4 * ri or v[i] > h + 4 * ri:
                continue
            x0 = max(int(u[i] - 4 * ri), 0)
            x1 = min(int(u[i] + 4 * ri) + 1, w)
            y0 = max(int(v[i] - 4 * ri), 0)
            y1 = min(int(v[i] + 4 * ri) + 1, h)
            d2 = ((xx[y0:y1, x0:x1] - u[i]) ** 2
                  + (yy[y0:y1, x0:x1] - v[i]) ** 2)
            img[y0:y1, x0:x1] += amp[i] * np.exp(-d2 / (2 * ri * ri))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames, np.asarray(centers), (fx, fy, cx, cy)


def run(cmd: list, timeout: float) -> tuple:
    """(stdout, wall s) of one CLI process started from the repository
    root; raises SystemExit with its output's tail when it fails."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=REPO)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-2000:] + res.stderr[-4000:])
        raise SystemExit(f"FAILED ({res.returncode}): {' '.join(cmd)}")
    return res.stdout, dt


def ate_report(rec_path: str, gt_centers: np.ndarray) -> dict:
    """Registered cameras and ATE of a reconstruction checkpoint against
    the ground-truth centers of every frame: the RMSE after a similarity
    alignment, the trajectory's length and the RMSE as a percentage of
    it."""
    from ..sfm.evaluate import ate_rmse
    z = np.load(rec_path)
    Rr, tr, reg = z["cam_R"], z["cam_t"], z["registered"]
    id2row = {int(c): k for k, c in enumerate(z["cam_ids"])}
    est = np.asarray([-Rr[id2row[int(c)]].T @ tr[id2row[int(c)]]
                      for c in reg])
    gt = np.asarray([gt_centers[int(c)] for c in reg])
    rmse = float(ate_rmse(est, gt))
    traj = float(np.sum(np.linalg.norm(np.diff(gt_centers, axis=0),
                                       axis=1)))
    return {"registered": int(len(reg)), "of": int(len(gt_centers)),
            "rmse": rmse, "trajectory_length": traj,
            "rmse_pct_of_traj": 100.0 * rmse / traj}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", nargs="*", type=int, default=[],
                    help="n_frames h w (default 100 240 320)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="popsift-sfm's --seed")
    ap.add_argument("--work", default=None,
                    help="directory for frames and outputs (default: a "
                         "new temporary directory)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    n_frames, h, w = (args.size + [100, 240, 320][len(args.size):])[:3]
    if args.out and os.path.abspath(args.out) == os.path.join(
            REPO, "E2E_r05.json"):
        raise SystemExit("E2E_r05.json is the JAX package's artifact")
    from ..io.image import write_pgm
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    work = args.work or tempfile.mkdtemp(prefix="e2e_proof_")
    os.makedirs(work, exist_ok=True)
    report = {"frames": n_frames, "size": [h, w], "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")}

    t0 = time.perf_counter()
    frames, gt_centers, (fx, fy, cx, cy) = render_sequence(n_frames, h, w)
    paths = []
    for i, fr in enumerate(frames):
        p = os.path.join(work, f"frame_{i:04d}.pgm")
        write_pgm(p, fr)
        paths.append(p)
    report["render_s"] = time.perf_counter() - t0

    py, d = sys.executable, ["--device", str(dev)]
    out, dt = run([py, "-m", "popsift_tpu_torch.cli.demo", "-i", paths[0],
                   "-o", os.path.join(work, "feats0.txt"),
                   "--print-time-info"] + d, 1200)
    nfeat = int(next(l for l in out.splitlines()
                     if "Number of features" in l).split()[-1])
    report["demo"] = {"features": nfeat, "wall_s": dt}

    out, dt = run([py, "-m", "popsift_tpu_torch.cli.match", "-l", paths[0],
                   "-r", paths[1], "--geom", "essential", "--fx", str(fx)]
                  + d, 1200)
    lines = out.splitlines()
    report["match"] = {
        "accepted": next((l for l in lines if "accepted matches" in l), ""),
        "verified": next((l for l in lines
                          if l.startswith("geometric verification")), ""),
        "wall_s": dt}

    rec_path = os.path.join(work, "rec.npz")
    out, dt = run([py, "-m", "popsift_tpu_torch.cli.sfm", "-i"] + paths
                  + ["--fx", str(fx), "--fy", str(fy), "--cx", str(cx),
                     "--cy", str(cy), "--retrieval", "8", "--refine",
                     "--seed", str(args.seed), "--export", rec_path,
                     "--export-colmap", os.path.join(work, "sparse"),
                     "--export-ply", os.path.join(work, "cloud.ply")] + d,
                  7200)
    lines = out.splitlines()
    report["sfm"] = {
        "wall_s": dt,
        "tracks": next((l for l in lines if l.startswith("tracks:")), ""),
        "final_ba": next((l for l in lines if "final BA cost" in l), ""),
        "refined": next((l for l in lines if "refined BA cost" in l), "")}
    report["ate"] = ate_report(rec_path, gt_centers)
    report["colmap_files"] = sorted(os.listdir(os.path.join(work,
                                                            "sparse")))
    report["ply_bytes"] = os.path.getsize(os.path.join(work, "cloud.ply"))
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
