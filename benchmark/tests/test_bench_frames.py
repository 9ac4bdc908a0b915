"""The copied frame generators and roofline arithmetic against their
originals (``bench.py``, ``chip_smoke.py``) and against counts made by
hand at small sizes."""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from harness import bounds, frames  # noqa: E402
from reference.gauss import Params, filter_tables  # noqa: E402


@pytest.mark.parametrize("hw", [(36, 52), (90, 160)])
def test_make_frame_copy_and_its_card_form(hw):
    import bench
    for seed in (0, 3):
        want = bench.make_frame(*hw, seed=seed)
        assert np.array_equal(frames.make_frame(*hw, seed=seed), want)
        got = frames.make_frame_on("cpu", *hw, seed)
        diff = np.abs(got.astype(int) - want.astype(int))
        # float32 exp and another order of the blob sums: a grey level,
        # at a pixel here and there
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2


def test_blob_scene_by_hand():
    """One blob on the sinusoids, no noise: pixel (x, y) by the formula;
    through a shift homography the view is the scene moved."""
    blobs = np.array([[10.0, 6.0, 3.0, 50.0]])
    noise = np.zeros((12, 20), np.float32)
    img = frames.blob_scene(blobs, noise, "cpu")
    for x, y in ((10, 6), (0, 0), (19, 11)):
        v = (96 + 40 * math.sin(x / 9) * math.cos(y / 11)
             + 30 * math.sin(x / 37 + y / 23)
             + 50 * math.exp(-((x - 10) ** 2 + (y - 6) ** 2) / 18))
        assert abs(int(img[y, x]) - min(255, int(v))) <= 1
    H = np.array([[1, 0, 2.0], [0, 1, 1.0], [0, 0, 1]])
    moved = frames.blob_scene(blobs, noise, "cpu", homography=H)
    assert abs(int(moved[7, 12]) - int(img[6, 10])) <= 1


def test_graf_pair_homography_maps_left_to_right():
    from harness.spec import load_module
    scene = load_module(os.path.join(BENCH, "scenes", "graf_pair.py"), "gp")
    spec = dict(blobs=16, blob_sigma=[1.5, 4.0], blob_amplitude=[20, 60],
                noise=0.0, homography=dict(rotation_deg=[5, 25],
                                           scale=[0.85, 1.15],
                                           perspective=2e-4))
    left, right, H = scene.pair(spec, 64, 80, 2 ** 31 + 9, 3, "cpu")
    assert left.shape == right.shape == (64, 80)
    assert not np.array_equal(left, right)
    c = H @ np.array([40.0, 32.0, 1.0])
    assert np.allclose(c[:2] / c[2], [40.0, 32.0])      # about the centre
    again = scene.pair(spec, 64, 80, 2 ** 31 + 9, 3, "cpu")
    assert np.array_equal(again[0], left) and np.array_equal(again[2], H)


DIMS_1080 = [(2160, 3840), (1080, 1920), (540, 960), (270, 480), (135, 240),
             (68, 120), (34, 60), (17, 30), (9, 15)]


def test_octaves_capacities_and_filters_of_the_configs():
    p = Params({})
    assert p.octave_dims(1920, 1080) == DIMS_1080
    caps = [p.capacity(*d) for d in DIMS_1080]
    assert caps == [16384, 16200, 4050, 1012, 512, 512, 512, 512, 512]
    assert sum(c + c // 4 for c in caps) == 50257
    graf = [p.capacity(*d) for d in p.octave_dims(800, 640)]
    assert sum(c + c // 4 for c in graf) == 29450
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.gauss import build_gauss_tables
    g = build_gauss_tables(SiftConfig())
    t = filter_tables(p)
    assert list(g.inc_span) == t["inc_span"]
    assert all(np.array_equal(a, b) for a, b in zip(g.inc, t["inc"]))
    assert np.array_equal(g.dd[0], t["dd0"])
    from popsift_tpu_torch.ops.descriptors import loop_patch_radius
    from popsift_tpu_torch.ops.pyramid import (build_pyramid_plan,
                                               first_thin_octave)
    assert bounds.loop_radius(p) == loop_patch_radius(SiftConfig())
    half = [s - 1 for s in t["inc_span"][1:]]
    for h, w in ((1080, 1920), (640, 800)):
        assert bounds.first_thin_octave(p.octave_dims(w, h), half, 3) == \
            first_thin_octave(build_pyramid_plan(SiftConfig(), h, w))


def test_bounds_against_chip_smoke_and_by_hand():
    import chip_smoke
    assert bounds.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert bounds.F32_FLOP_PER_S == chip_smoke.F32_FLOP_PER_S
    assert bounds.refine_bound(2110, 40206) == pytest.approx(
        chip_smoke.refine_bound(2110, 40206)[0] * 1e-3)
    sig = np.array([1.6, 2.5, 4.1])
    assert bounds.ori_bound(sig, 100) == pytest.approx(
        chip_smoke.ori_bound(torch.tensor(sig), 100)[0] * 1e-3)
    assert bounds.desc_bound(sig, 42, 100) == pytest.approx(
        chip_smoke.desc_bound(torch.tensor(sig), 42, 100)[0] * 1e-3)
    # by hand: one 4 x 4 octave, Z = 1, two 3-tap levels (half-width 1)
    assert bounds.mask_bound([(4, 4)], 1) == pytest.approx(
        16 * (3 * 4 + 1) / 3.35e12)
    assert bounds.compact_bound([(4, 4)], 1, [8]) == pytest.approx(
        (16 + 12 * 8 + 16) / 3.35e12)
    # 1080p: octaves 6-8 are thin (34 x 60 and below, PERF.md)
    assert bounds.first_thin_octave(DIMS_1080, [3, 4, 5, 7, 9], 3) == 6
    assert bounds.first_thin_octave(DIMS_1080, [3, 4, 5, 7, 25], 3) == 9
    # no thin octave: 12 bytes a pixel and level, the picks; two levels
    px = [128 * 192, 64 * 96]
    want = max((12 * 2 * sum(px) + 4 * px[1]) / 3.35e12,
               sum(p * (2 * (1 + 3) + 1) for p in px) * 2 / 67e12)
    assert bounds.front_bound([(128, 192), (64, 96)], [1, 1]) == \
        pytest.approx(want)
    # the exact matcher on 92,160 padded rows a side: 32.45 ms (PERF.md)
    assert bounds.match_bound(92160, 92160) == pytest.approx(32.45e-3,
                                                             rel=1e-3)
