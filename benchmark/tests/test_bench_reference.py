"""The benchmark's plain reference against the program on the CPU at
small sizes: extraction, a capacity too small for the frame caught as
missed keypoints, the ratio test and homography RANSAC from the same
ranks."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from harness import compare, frames  # noqa: E402
from reference import geometry, sift  # noqa: E402
from reference.gauss import Params  # noqa: E402

FIELDS = ("x", "y", "sigma", "octave", "orientations", "ori_valid",
          "descriptors", "desc_to_kp")


def program(img, **fields):
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    fh = PopSift(SiftConfig(**fields), device="cpu").enqueue(img).get()
    return {k: getattr(fh, k) for k in FIELDS}


@pytest.mark.parametrize("case", [
    dict(hw=(96, 128), seed=0, fields={}),
    dict(hw=(135, 240), seed=2 ** 31 + 5, fields={}),
    dict(hw=(270, 480), seed=7, fields={"extrema_capacity": 1024}),
])
def test_reference_extraction_agrees_with_the_program(case):
    img = frames.make_frame(*case["hw"], seed=case["seed"])
    p = Params(case["fields"])
    got = program(img, **case["fields"])
    ref = sift.extract(torch.from_numpy(img), p)
    nums, gaps, _ = compare.feature_numbers(got, ref, p)
    assert len(ref["x"]) > 10
    assert nums == {"kp_miss_pct": 0.0, "desc_miss_pct": 0.0}
    assert gaps["kp_gap"] < 2e-3 and gaps["desc_gap"] < 2e-3


def test_a_capacity_too_small_for_the_frame_is_caught():
    """The program keeps 8 candidates an octave; the reference keeps them
    all, as PopSift does below its max_extrema."""
    img = frames.make_frame(270, 480, seed=7)
    p = Params({"extrema_capacity": 8})
    got = program(img, extrema_capacity=8)
    ref = sift.extract(torch.from_numpy(img), p)
    assert (ref["candidates"] > 8).sum() >= 2
    nums, _, _ = compare.feature_numbers(got, ref, p)
    assert nums["kp_miss_pct"] > 50.0


def test_control_is_far_from_the_reference():
    img = frames.make_frame(96, 128, seed=1)
    p = Params({})
    ref = sift.extract(torch.from_numpy(img), p)
    ctl = sift.extract(torch.from_numpy(img), p, dtype=torch.bfloat16)
    nums, _, _ = compare.feature_numbers(ctl, ref, p)
    assert nums["kp_miss_pct"] > 50 and nums["desc_miss_pct"] > 50


def test_ratio_test_agrees_with_the_program():
    from popsift_tpu_torch.ops.matching import match_descriptors
    g = torch.Generator().manual_seed(3)
    a = torch.rand(300, 128, generator=g)
    b = torch.cat([a[:200] + 0.01 * torch.rand(200, 128, generator=g),
                   torch.rand(150, 128, generator=g)])
    a, b = a / a.norm(dim=1, keepdim=True), b / b.norm(dim=1, keepdim=True)
    res = match_descriptors(a, torch.ones(300, dtype=torch.bool), b,
                            torch.ones(350, dtype=torch.bool))
    rows = torch.nonzero(res.accept)[:, 0]
    left, right = geometry.ratio_matches(a, b)
    assert torch.equal(left, rows) and torch.equal(right,
                                                   res.best_idx[rows])
    assert len(rows) >= 190


def test_ransac_agrees_with_the_program_from_the_same_ranks():
    from popsift_tpu_torch.sfm.twoview import ransac_homography
    rng = np.random.default_rng(4)
    H = np.array([[0.95, -0.2, 30.0], [0.18, 1.02, -12.0], [1e-4, -5e-5, 1]])
    x1 = rng.uniform(0, 400, (200, 2))
    h = np.c_[x1, np.ones(200)] @ H.T
    x2 = h[:, :2] / h[:, 2:] + rng.normal(0, 0.5, (200, 2))
    x2[150:] = rng.uniform(0, 400, (50, 2))               # outliers
    ranks = torch.from_numpy(rng.integers(0, 200, (512, 4)))
    t1, t2 = (torch.from_numpy(x.astype(np.float32)) for x in (x1, x2))
    got = ransac_homography(None, t1, t2, torch.ones(200, dtype=torch.bool),
                            thresh=4.0, ranks=ranks).inliers
    want = geometry.ransac_homography(t1, t2, ranks, 4.0)
    # the same hypothesis wins; its f32 model puts a point or two on the
    # other side of the 2 px gate than the f64 one
    assert int((got != want).sum()) <= 2 and 140 <= int(want.sum()) <= 155
