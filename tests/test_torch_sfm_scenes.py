"""popsift_tpu_torch/tools/sfm_scenes.py against the JAX package's test
scene makers (tests/test_sfm_incremental.py::make_multiview /
tracks_from_gt, tests/test_sfm_scale.py::make_sequence /
tracks_from_vis, tests/test_global_sfm.py::_rand_rot / _graph) for
the same seeds: indices equal, coordinates within 1e-5 (the rotations
come from two f32 ``exp_so3``s)."""

import numpy as np
import pytest

from popsift_tpu_torch.tools import sfm_scenes as S
import test_global_sfm as JG
import test_sfm_incremental as JI
import test_sfm_scale as JS


def _same_tracks(a, b):
    for f in ("track_id", "image_id", "feature_id"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert a.n_tracks == b.n_tracks
    np.testing.assert_allclose(a.uv, b.uv, rtol=0, atol=1e-5 * 640)


@pytest.mark.parametrize("seed,n_pts,n_cams,noise", [
    (7, 80, 5, 0.3), (9, 80, 5, 0.3), (7, 60, 5, 0.0), (3, 96, 2, 0.0)])
def test_make_multiview_matches_the_jax_tests(seed, n_pts, n_cams, noise):
    got = S.make_multiview(np.random.default_rng(seed), n_pts, n_cams, noise)
    want = JI.make_multiview(np.random.default_rng(seed), n_pts, n_cams,
                             noise)
    np.testing.assert_array_equal(got[0], want[0])
    for (Rg, tg), (Rw, tw) in zip(got[1], want[1]):
        np.testing.assert_allclose(Rg, Rw, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tg, tw, rtol=0, atol=1e-5)
    assert list(got[2]) == list(want[2])
    for img in want[2]:
        np.testing.assert_allclose(got[2][img], want[2][img], rtol=0,
                                   atol=1e-5 * 640)
    _same_tracks(S.tracks_from_gt(got[2], n_pts),
                 JI.tracks_from_gt(want[2], n_pts))


@pytest.mark.parametrize("seed,kw", [
    (2, dict(n_cams=40)), (11, dict(n_cams=40)),
    (13, dict(n_pts=1200, n_cams=200, noise=0.2)),
    (13, dict(n_cams=80, noise=0.2, span=30.0, vis_pts=240)),
    (17, dict(n_pts=300, n_cams=50, noise=0.2, span=22.5, vis_pts=300))])
def test_make_sequence_matches_the_jax_tests(seed, kw):
    got = S.make_sequence(np.random.default_rng(seed), **kw)
    want = JS.make_sequence(np.random.default_rng(seed), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    for (Rg, tg), (Rw, tw) in zip(got[1], want[1]):
        np.testing.assert_allclose(Rg, Rw, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tg, tw, rtol=0, atol=1e-5 * 50)
    assert list(got[3]) == list(want[3])
    for img in want[3]:
        assert np.array_equal(got[3][img], want[3][img])
        np.testing.assert_allclose(got[2][img], want[2][img], rtol=0,
                                   atol=1e-5 * 640)
    _same_tracks(S.tracks_from_vis(got[2], got[3]),
                 JS.tracks_from_vis(want[2], want[3]))


@pytest.mark.parametrize("seed,n", [(0, 30), (5, 24), (4, 7)])
def test_view_graph_and_rotations_match_the_jax_tests(seed, n):
    got_rng, want_rng = (np.random.default_rng(seed) for _ in range(2))
    for a, b in zip(S.view_graph(got_rng, n), JG._graph(want_rng, n)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for scale in (1.0, 0.005):
        np.testing.assert_allclose(S.random_rotation(got_rng, scale),
                                   JG._rand_rot(want_rng, scale),
                                   rtol=0, atol=1e-6)
