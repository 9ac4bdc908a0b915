"""Ports of tests/test_sfm_scale.py through the port alone (the driver on
the CPU, its own generator, the scenes of tools/sfm_scenes.py), marked
``slow`` as the originals are. The distributed BA runs on 8 gloo CPU
ranks (``parallel/launch.py::spawn``) where JAX's runs on its 8-device
CPU mesh."""

import time

import numpy as np
import pytest
import torch

from popsift_tpu_torch.parallel.launch import spawn
from popsift_tpu_torch.sfm.ba import bundle_adjust
from popsift_tpu_torch.sfm.evaluate import ate_rmse
from popsift_tpu_torch.sfm.incremental import IncrementalSfM
from popsift_tpu_torch.tools import rank_cases
from popsift_tpu_torch.tools.sfm_scenes import (INTR, camera_centers,
                                                make_sequence,
                                                tracks_from_vis)


def _ate(sfm, cams):
    reg = sorted(sfm.rec.registered)
    return ate_rmse(camera_centers(sfm.rec, reg), camera_centers(cams, reg))


@pytest.mark.slow
def test_sequence_reconstruction_scale():
    """Port of :77-125: the 40-camera sequence, then the final problem's
    distributed BA (``make_distributed_ba_fn`` on
    ``partition_by_point(prob, 8)``, 8 gloo CPU ranks) against the
    single-process ``bundle_adjust``: the same start cost (rtol 1e-4)
    and the final cost within 1 %."""
    rng = np.random.default_rng(11)
    n_cams = 40
    X, cams, kps, vis = make_sequence(rng, n_cams=n_cams)
    tracks = tracks_from_vis(kps, vis)

    sfm = IncrementalSfM(tracks, INTR, ba_every=10, device="cpu")
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    n_reg = len(sfm.rec.registered)
    assert n_reg >= n_cams - 2, f"registered only {n_reg}/{n_cams}"
    costs = sfm.global_ba(iters=10)
    assert costs[-1] < costs[0]
    rmse = _ate(sfm, cams)
    assert rmse < 0.1, f"ATE {rmse}"

    prob, _, _ = sfm.as_ba_problem()
    _, single_costs = bundle_adjust(prob, iters=3)
    assert bool(torch.isfinite(single_costs).all())
    assert float(single_costs[-1]) <= float(single_costs[0])

    # the distributed final BA must agree with the single-process one
    # (the problem enters converged from global_ba, so LM holds it flat)
    fields = {k: v.cpu().numpy() for k, v in prob._asdict().items()}
    ranks = spawn(rank_cases.ba_cases, 8, "gloo", "cpu", timeout=600,
                  args=({"final": (fields, dict(iters=3, cg_iters=20))},))
    dist_costs = ranks[0]["final"]["costs"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["final"]["costs"], dist_costs)
    np.testing.assert_allclose(float(dist_costs[0]),
                               float(single_costs[0]), rtol=1e-4)
    rel = abs(float(dist_costs[-1]) - float(single_costs[-1])) \
        / max(float(single_costs[-1]), 1e-9)
    assert rel < 0.01, (float(dist_costs[-1]), float(single_costs[-1]))


@pytest.mark.slow
def test_sequence_reconstruction_200_cams():
    """Port of :203-241."""
    rng = np.random.default_rng(13)
    n_cams, n_pts = 200, 1200
    X, cams, kps, vis = make_sequence(rng, n_pts=n_pts, n_cams=n_cams,
                                      noise=0.2)
    tracks = tracks_from_vis(kps, vis)

    t0 = time.time()
    sfm = IncrementalSfM(tracks, INTR, ba_every=25, register_batch=8,
                         device="cpu")
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    n_reg = len(sfm.rec.registered)
    assert n_reg >= n_cams - 4, f"registered only {n_reg}/{n_cams}"
    costs = sfm.global_ba(iters=8)
    assert costs[-1] <= costs[0]
    wall = time.time() - t0
    rmse = _ate(sfm, cams)
    assert rmse < 0.5, f"ATE {rmse}"
    assert wall < 900, f"200-cam reconstruction took {wall:.0f}s"
    print(f"200 cams: {n_reg} registered, ATE {rmse:.3f}, {wall:.0f}s")


@pytest.mark.slow
def test_local_ba_windowed_sequence():
    """Port of :244-273."""
    rng = np.random.default_rng(13)
    n_cams = 80
    X, cams, kps, vis = make_sequence(rng, n_cams=n_cams, noise=0.2,
                                      span=0.25 * n_cams + 10,
                                      vis_pts=240)
    tracks = tracks_from_vis(kps, vis)

    sfm = IncrementalSfM(tracks, INTR, ba_every=50, register_batch=8,
                         local_ba_window=12, device="cpu")
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    n_reg = len(sfm.rec.registered)
    assert n_reg >= n_cams - 4, f"registered only {n_reg}/{n_cams}"
    sfm.global_ba(iters=8)
    reg = sorted(sfm.rec.registered)
    C_gt = camera_centers(cams, reg)
    extent = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    rmse = _ate(sfm, cams)
    assert rmse < 0.01 * extent, f"ATE {rmse} vs extent {extent}"
