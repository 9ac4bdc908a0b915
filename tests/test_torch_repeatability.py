"""popsift_tpu_torch.eval.repeatability: the cases of
tests/test_repeatability.py through the port's copy, the end-to-end one
on the port's own extraction (``PopSift(device="cpu")``)."""

import numpy as np
import torch

from popsift_tpu_torch.eval.repeatability import (
    evaluate_pair, project, strongest_descriptor_per_keypoint, warp_image)

torch.set_num_threads(1)


def test_project_identity_and_translation():
    pts = np.array([[1.0, 2.0], [5.0, 7.0]])
    np.testing.assert_allclose(project(np.eye(3), pts), pts)
    T = np.eye(3)
    T[0, 2], T[1, 2] = 3.0, -1.0
    np.testing.assert_allclose(project(T, pts), pts + [3.0, -1.0])


def test_evaluate_pair_perfect():
    kp = np.array([[10.0, 10.0], [50.0, 30.0], [90.0, 70.0]])
    desc = np.eye(3, 128, dtype=np.float32)
    s = evaluate_pair(kp, desc, kp, desc, np.eye(3), (100, 100))
    assert s.repeatability == 1.0
    assert s.matching_score == 1.0
    assert s.n_common == 3


def test_evaluate_pair_visibility():
    kp_a = np.array([[10.0, 10.0], [500.0, 30.0]])   # 2nd leaves image B
    desc = np.eye(2, 128, dtype=np.float32)
    s = evaluate_pair(kp_a, desc, kp_a[:1], desc[:1], np.eye(3), (100, 100))
    assert s.n_common == 1
    assert s.repeatability == 1.0


def test_warp_image_translation(rng):
    img = rng.integers(0, 255, size=(40, 60), dtype=np.uint8)
    H = np.eye(3)
    H[0, 2] = 5.0   # shift right by 5
    out = warp_image(img, H)
    np.testing.assert_array_equal(out[:, 5:], img[:, :-5])
    assert (out[:, :5] == 0).all()


def test_pipeline_repeatability_under_rotation(medium_image):
    """End-to-end through the port on the CPU: extraction is repeatable
    under a small rotation (the offline stand-in for the Oxford
    matching-score gate), and ``strongest_descriptor_per_keypoint`` reads
    the port's ``FeaturesHost``."""
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig

    a = np.deg2rad(5.0)
    h, w = medium_image.shape
    c = np.array([w / 2, h / 2])
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    t = c - R @ c
    H = np.array([[R[0, 0], R[0, 1], t[0]],
                  [R[1, 0], R[1, 1], t[1]],
                  [0.0, 0.0, 1.0]])
    warped = warp_image(medium_image, H)

    ps = PopSift(SiftConfig(), device="cpu")
    f1 = ps.enqueue(medium_image).get()
    kp1, d1 = strongest_descriptor_per_keypoint(f1)
    kp2, d2 = strongest_descriptor_per_keypoint(ps.enqueue(warped).get())
    assert len(kp1) == f1.getFeatureCount() and d1.shape == (len(kp1), 128)
    first = {}
    for di, k in enumerate(f1.desc_to_kp):
        first.setdefault(int(k), di)
    np.testing.assert_array_equal(d1, f1.descriptors[[first[i] for i in
                                                      range(len(kp1))]])
    s = evaluate_pair(kp1, d1, kp2, d2, H, warped.shape, eps=3.0)
    assert s.n_common >= 10
    assert s.repeatability >= 0.5, s
    assert s.matching_score >= 0.4, s
