"""popsift_tpu_torch.sfm.tracks (the port's copy) against
popsift_tpu.sfm.tracks: ports of tests/test_sfm_incremental.py:54-72 run
through both packages, and ``build_tracks`` equal field for field on
random match dicts (exact: both are the same numpy code)."""

import numpy as np
import pytest

from popsift_tpu.sfm import tracks as JT
from popsift_tpu_torch.sfm import tracks as TT


def _assert_same_tracks(a, b):
    assert a.n_tracks == b.n_tracks
    for name in ("track_id", "image_id", "feature_id", "uv"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name


@pytest.mark.parametrize("mod", [JT, TT], ids=["jax_package", "port"])
def test_build_tracks_union_find(mod):
    """Port of tests/test_sfm_incremental.py:54-63."""
    kps = {0: np.zeros((4, 2), np.float32),
           1: np.ones((4, 2), np.float32),
           2: 2 * np.ones((4, 2), np.float32)}
    matches = {(0, 1): np.array([[0, 1], [1, 2]]),
               (1, 2): np.array([[1, 3], [2, 0]])}
    t = mod.build_tracks(matches, kps)
    # track A: (0,0)-(1,1)-(2,3); track B: (0,1)-(1,2)-(2,0)
    assert t.n_tracks == 2
    assert len(t.track_id) == 6
    _assert_same_tracks(t, JT.build_tracks(matches, kps))


@pytest.mark.parametrize("mod", [JT, TT], ids=["jax_package", "port"])
def test_build_tracks_drops_inconsistent(mod):
    """Port of tests/test_sfm_incremental.py:66-72."""
    kps = {0: np.zeros((4, 2), np.float32), 1: np.zeros((4, 2), np.float32)}
    # feature (0,0) matches two different features of image 1 -> fold into
    # one track with two obs in image 1 -> dropped
    matches = {(0, 1): np.array([[0, 1], [0, 2]])}
    t = mod.build_tracks(matches, kps)
    assert t.n_tracks == 0
    _assert_same_tracks(t, JT.build_tracks(matches, kps))


@pytest.mark.parametrize("seed,min_length", [(0, 2), (1, 3), (2, 2)])
def test_build_tracks_equal_on_random_matches(seed, min_length):
    rng = np.random.default_rng(seed)
    n_img, n_feat = 6, 40
    kps = {i: rng.uniform(0, 640, (n_feat, 2)).astype(np.float32)
           for i in range(n_img)}
    matches = {}
    for i in range(n_img):
        for j in range(i + 1, n_img):
            m = int(rng.integers(0, 30))
            matches[(i, j)] = np.stack([rng.integers(0, n_feat, m),
                                        rng.integers(0, n_feat, m)], 1)
    got = TT.build_tracks(matches, kps, min_length=min_length)
    want = JT.build_tracks(matches, kps, min_length=min_length)
    assert want.n_tracks > 0
    _assert_same_tracks(got, want)
    some = np.arange(0, want.n_tracks, 3)
    for a, b in zip(got.observations_of(some), want.observations_of(some)):
        assert np.array_equal(a, b)
