"""popsift_tpu_torch.sfm.global_sfm's driver against the JAX package's
on the CPU: ``_triangulate_all`` from the same registered cameras, and
``global_sfm`` end to end on make_sequence(seed 2, 12 cameras) with
JAX's sample ranks (tests/test_torch_incremental.py::Replay): the same
view-graph edges, all cameras registered, the same accepted tracks
within 3, and centers within 1e-3 x the trajectory's extent after a
similarity alignment (both runs' BAs fix camera 0 only, so the scale is
rounding's to move; ROADMAP C). Then the port of the JAX package's
40-camera end to end, with its gates.
"""

import numpy as np
import pytest
import torch

from popsift_tpu.sfm import global_sfm as JG
from popsift_tpu.sfm import incremental as JI
from popsift_tpu_torch.sfm import global_sfm as TG
from popsift_tpu_torch.sfm import incremental as TI
from popsift_tpu_torch.sfm.evaluate import ate_rmse, umeyama
from popsift_tpu_torch.tools.sfm_scenes import (INTR, camera_centers,
                                                make_sequence,
                                                tracks_from_vis)
from test_torch_incremental import Replay

torch.set_num_threads(1)


def _sequence(n_cams, seed=2):
    rng = np.random.default_rng(seed)
    X, cams, kps, vis = make_sequence(rng, n_cams=n_cams)
    return cams, tracks_from_vis(kps, vis)


def test_triangulate_all_matches_jax():
    """The same registered cameras (the 12-camera sequence's true poses,
    camera 11 left out) in both drivers: the same accepted tracks, X
    within 1e-5 relative."""
    cams, tracks = _sequence(12)
    drivers = [JI.IncrementalSfM(tracks, INTR),
               TI.IncrementalSfM(tracks, INTR, device="cpu")]
    for drv in drivers:
        for i in range(11):
            drv.rec.cam_R[i], drv.rec.cam_t[i] = cams[i]
            drv._mark_registered(i)
    JG._triangulate_all(drivers[0])
    TG._triangulate_all(drivers[1])
    want, got = (dict(drv.rec.points.items()) for drv in drivers)
    assert sorted(got) == sorted(want) and len(want) > 150
    for t, X in want.items():
        np.testing.assert_allclose(got[t], X, rtol=0,
                                   atol=1e-5 * np.linalg.norm(X))
    assert np.array_equal(drivers[1]._seen, drivers[0]._seen)


@pytest.fixture
def edge_spy(monkeypatch):
    """Records the accepted view-graph edges each package's global_sfm
    passes to rotation averaging."""
    edges = {}
    for key, mod in (("jax", JG), ("torch", TG)):
        def spy(n, ei, ej, *a, _f=mod.rotation_averaging, _k=key, **kw):
            edges[_k] = (np.asarray(ei).astype(np.int64),
                         np.asarray(ej).astype(np.int64))
            return _f(n, ei, ej, *a, **kw)
        monkeypatch.setattr(mod, "rotation_averaging", spy)
    return edges


def test_global_sfm_matches_jax(edge_spy, monkeypatch):
    """12 cameras, JAX's ranks (the port's driver replays JAX's key
    chain)."""
    cams, tracks = _sequence(12)
    want = JG.global_sfm(tracks, INTR, min_covis=30, max_edges=120)
    monkeypatch.setattr(TI, "IncrementalSfM", Replay)
    got = TG.global_sfm(tracks, INTR, min_covis=30, max_edges=120,
                        device="cpu")
    assert isinstance(got, Replay)
    for a, b in zip(edge_spy["torch"], edge_spy["jax"]):
        assert np.array_equal(a, b)
    assert len(edge_spy["jax"][0]) >= 11
    assert sorted(got.rec.registered) == sorted(want.rec.registered) \
        == list(range(12))
    assert len(set(got.rec.points) ^ set(want.rec.points)) <= 3
    gt = camera_centers(cams, range(12))
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    a, b = (camera_centers(d.rec, range(12)) for d in (got, want))
    s, R, t = umeyama(a, b)
    gap = np.linalg.norm(a @ (s * R).T + t - b, axis=1).max()
    assert gap <= 1e-3 * extent, (gap, extent)
    assert ate_rmse(a, gt) < 0.5


def test_global_sfm_device_defaults_to_cuda():
    _, tracks = _sequence(4)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError):
        TG.global_sfm(tracks, INTR)


def test_global_sfm_end_to_end():
    """Port of tests/test_global_sfm.py:143-161: 40 cameras through the
    whole global pipeline."""
    cams, tracks = _sequence(40)
    drv = TG.global_sfm(tracks, INTR, min_covis=30, max_edges=120,
                        device="cpu")
    reg = sorted(drv.rec.registered)
    assert len(reg) == 40
    rmse = ate_rmse(camera_centers(drv.rec, reg), camera_centers(cams, reg))
    assert rmse < 0.5, f"ATE {rmse}"
