"""Large-scale incremental-SfM benchmark of the port's driver.

The port's copy of scripts/bench_sfm_scale.py: it reconstructs an
n-camera synthetic forward-motion sequence (``tools/sfm_scenes.py``,
the generator of tests/test_sfm_scale.py: seed 17, 6 n points, 0.2 px,
the cloud stretched with the trajectory, 400 points a camera) with the
same driver settings (``ba_every=25``, ``register_batch=8``,
``local_ba_window=25``, then ``refine(rounds=3, ba_iters=12)``) and
prints one line of JSON:

  * wall time per phase (initialize / registration loop / final BA),
  * the time inside each device entry point the driver calls
    (ransac_essential, recover_pose, refine_pose, triangulate_rows,
    ransac_pnp_batch, and bundle_adjust split into the calls of
    ``global_ba`` and ``local_ba``), measured on the card with CUDA
    events around each call and a synchronize after it (on the CPU with
    the host clock), and "host" as the rest of the wall time,
  * the ATE gate (1 % of the trajectory's extent, as the tests).

Usage, from the repository root:

    python -m popsift_tpu_torch.tools.sfm_scale [n_cams] [--device cuda]
                                                [--trace]

``--device`` defaults to ``cuda``; without a card that raises.
``--trace`` also prints, before the record, one JSON line after each
``register_next``: the images registered, the ATE of the registered
cameras, the points, the BA calls so far and the wall time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


class DeviceTimer:
    """Wraps device entry points that a module imported by name, and
    sums the time spent inside them: CUDA events around the call and a
    synchronize after it on a CUDA device, the host clock on the CPU.
    ``bundle_adjust`` is booked under the driver method that called it
    (``bundle_adjust_global`` / ``bundle_adjust_local``). ``restore``
    puts the original functions back."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.total = 0.0
        self.calls = {}
        self._saved = []

    def elapsed(self, fn, a, k):
        """(fn(*a, **k), seconds inside the call)."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*a, **k)
            return out, time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **k)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3

    def wrap(self, mod, name):
        fn = getattr(mod, name)

        def timed(*a, **k):
            key = name
            if name == "bundle_adjust":
                caller = sys._getframe(1).f_code.co_name
                key = ("bundle_adjust_local" if caller == "local_ba"
                       else "bundle_adjust_global")
            out, dt = self.elapsed(fn, a, k)
            self.total += dt
            c, s = self.calls.get(key, (0, 0.0))
            self.calls[key] = (c + 1, s + dt)
            return out

        self._saved.append((mod, name, fn))
        setattr(mod, name, timed)

    def restore(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


# the device entry points the incremental driver calls by name
DRIVER_CALLS = ("ransac_essential", "recover_pose", "refine_pose",
                "triangulate_rows", "ransac_pnp_batch", "bundle_adjust")


def run(n_cams: int, device="cuda", trace: bool = False) -> dict:
    """Reconstruct the ``n_cams`` sequence on ``device``; the JSON
    record of bench_sfm_scale.py, with the device's name. ``trace``
    prints the registration's progress (see the module docstring)."""
    from ..sfm import incremental as inc
    from ..sfm.evaluate import ate_rmse
    from ..utils.device import resolve_device
    from .sfm_scenes import (INTR, camera_centers, make_sequence,
                             tracks_from_vis)

    dev = resolve_device(device)
    n_pts = 6 * n_cams
    timer = DeviceTimer(dev)
    for name in DRIVER_CALLS:
        timer.wrap(inc, name)
    try:
        rng = np.random.default_rng(17)
        t0 = time.perf_counter()
        # stretch the cloud with the 0.25/frame trajectory and pin the
        # per-camera visibility to ~400 points (the fixed [-4, 12] box
        # degenerates past ~200 cameras)
        X, cams, kps, vis = make_sequence(rng, n_pts=n_pts, n_cams=n_cams,
                                          noise=0.2,
                                          span=0.25 * n_cams + 10,
                                          vis_pts=min(400, n_pts))
        tracks = tracks_from_vis(kps, vis)
        t_gen = time.perf_counter() - t0
        n_obs = len(np.asarray(tracks.track_id))

        t0 = time.perf_counter()
        # windowed local BA after every batch + bounded-spacing global BA
        sfm = inc.IncrementalSfM(tracks, INTR, ba_every=25,
                                 register_batch=8, local_ba_window=25,
                                 device=dev)
        sfm.initialize()
        t_init = time.perf_counter() - t0

        t0 = time.perf_counter()
        while sfm.register_next() is not None:
            if trace:
                reg = sorted(sfm.rec.registered)
                print(json.dumps({
                    "registered": len(reg),
                    "ate_rmse": float(ate_rmse(camera_centers(sfm.rec, reg),
                                               camera_centers(cams, reg))),
                    "points": len(sfm.rec.points),
                    "ba_calls": {k: c for k, (c, _) in timer.calls.items()
                                 if k.startswith("bundle_adjust")},
                    "wall_s": round(time.perf_counter() - t0, 3)}),
                    flush=True)
        t_reg = time.perf_counter() - t0

        t0 = time.perf_counter()
        # final polish: robust BA -> cull gross points -> retriangulate
        costs = sfm.refine(rounds=3, ba_iters=12)
        t_ba = time.perf_counter() - t0
    finally:
        timer.restore()

    reg = sorted(sfm.rec.registered)
    C_est = camera_centers(sfm.rec, reg)
    C_gt = camera_centers(cams, reg)
    rmse = ate_rmse(C_est, C_gt)
    extent = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    wall = t_init + t_reg + t_ba
    return {
        "n_cams": n_cams,
        "n_tracks": int(tracks.n_tracks),
        "n_obs": n_obs,
        "registered": len(reg),
        "ate_rmse": round(float(rmse), 4),
        "trajectory_extent": round(extent, 1),
        "ate_gate_1pct": bool(rmse < 0.01 * extent),
        "final_ba_cost": round(float(costs[-1]), 2),
        "wall_s": {"generate": round(t_gen, 3),
                   "initialize": round(t_init, 3),
                   "register_loop": round(t_reg, 3),
                   "final_ba": round(t_ba, 3),
                   "total": round(wall, 3)},
        "device_s": round(timer.total, 3),
        "host_s": round(wall - timer.total, 3),
        "device_calls": {k: [c, round(s, 3)]
                         for k, (c, s) in sorted(timer.calls.items())},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_cams", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", action="store_true",
                    help="print the registration's progress")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n_cams, args.device, args.trace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
