"""BAL bundle adjustment on the card: the benchmark cell's problem at
Dubrovnik-88's published size against the float64 reference, no host
synchronisation inside ``bundle_adjust``, and the 6-wide path's results
unchanged.

These tests need a CUDA device; they skip without one. On the card:

    python -m pytest tests/test_torch_bal_cuda.py -q --noconftest -m cuda

Tolerances: the benchmark cell's limits
(``benchmark/limits/bal_dubrovnik88_lm10.json``, each with its reason in
PERF.md), on the same numbers. The 6-wide results are held to those of
the tree before the 9-wide model was added (``tests/golden/ba6_h100.json``,
recorded on an NVIDIA H100 with PyTorch 2.11 / CUDA 12.8), both runs with
deterministic segment sums (``torch.use_deterministic_algorithms``): equal
on that card and library, and within 1e-6 relative (costs; 1e-6 of the
first iteration's cost, where the noiseless scene's cost falls to
rounding) and 1e-5 of the largest entry (cameras) elsewhere, since
another cuBLAS may order the GEMM's sums otherwise.
"""

import json
import os

import numpy as np
import pytest
import torch

from popsift_tpu_torch.sfm import ba as B
from popsift_tpu_torch.sfm import bal as BAL
from popsift_tpu_torch.sfm import bal_reference as REF
from popsift_tpu_torch.tools import bal_scene as SC
from popsift_tpu_torch.tools.sfm_scenes import ba_scene
from torch_card import card_device

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dev():
    return card_device("the cell's size runs on the card")


@pytest.fixture(scope="module")
def dubrovnik(dev):
    return SC.bal_scene(2 ** 31 + 2021)


def test_dubrovnik_size_against_the_reference(dev, dubrovnik):
    fields, _ = dubrovnik
    with open(os.path.join(REPO, "benchmark", "limits",
                           "bal_dubrovnik88_lm10.json")) as fh:
        limits = json.load(fh)
    p = BAL.problem_from_bal(fields, dev)
    assert B.dense_schur_feasible(88, 64298, width=B.cam_dim(p))
    out, costs = B.bundle_adjust(p, iters=10)
    T = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in fields.items()}
    rc, rp, rcost = REF.bundle_adjust(T["cams"], T["points"], T["obs_cam"],
                                      T["obs_pt"], T["obs_uv"])
    c0 = float(REF._cost(T["cams"], T["points"], T["obs_cam"], T["obs_pt"],
                         T["obs_uv"]))
    assert float(costs[-1]) < 0.1 * c0
    before = torch.cat([rcost.new_full((1,), c0), rcost[:-1]])
    assert float((100 * (costs.double() - rcost).abs() / before).max()) \
        <= limits["cost_gap_pct"]
    gap = (REF.reprojections(out.cams, out.points, p.obs_cam, p.obs_pt)
           - REF.reprojections(rc, rp, p.obs_cam, p.obs_pt)).norm(dim=1)
    assert float(torch.quantile(gap.float().cpu(), 0.999)) \
        <= limits["reproj_gap_px"]
    cams = out.cams.double()
    assert float((100 * (cams[:, 6] - rc[:, 6]).abs() / rc[:, 6]).max()) \
        <= limits["focal_gap_pct"]
    assert float((cams[:, 7] - rc[:, 7]).abs().max()) <= limits["k1_gap"]
    assert float((cams[:, 8] - rc[:, 8]).abs().max()) <= limits["k2_gap"]


def test_bundle_adjust_does_not_synchronize(dev, dubrovnik):
    fields, _ = dubrovnik
    p = BAL.problem_from_bal(fields, dev)
    six = B.problem_from_numpy(_six_wide(), dev)
    for q in (p, six):
        for dense in (True, False):
            B.bundle_adjust(q, iters=2, dense=dense)         # warm-up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                B.bundle_adjust(q, iters=2, dense=dense)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()


def _six_wide():
    fields, _ = ba_scene(7, noise_px=1.0, n_cams=20, n_points=2000)
    return fields


def test_six_wide_results_unchanged(dev):
    with open(os.path.join(REPO, "tests", "golden", "ba6_h100.json")) as fh:
        golden = json.load(fh)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for noise in (0.0, 1.0):
            fields, _ = ba_scene(7, noise_px=noise)
            p = B.problem_from_numpy(fields, dev)
            for name, dense in (("dense", True), ("cg", False)):
                want = golden[f"{name}_{noise}"]
                q, costs = B.bundle_adjust(p, iters=10, dense=dense)
                costs = costs.cpu().numpy().astype(float)
                cams = q.cams.cpu().numpy().astype(float)
                np.testing.assert_allclose(costs, want["costs"], rtol=1e-6,
                                           atol=1e-6 * want["costs"][0])
                ref = np.asarray(want["cams"])
                np.testing.assert_allclose(cams, ref, rtol=0,
                                           atol=1e-5 * np.abs(ref).max())
    finally:
        torch.use_deterministic_algorithms(was)
