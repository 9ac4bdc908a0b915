"""popsift_tpu_torch.sfm.incremental against popsift_tpu.sfm.incremental
on the CPU, plus ports of the JAX package's incremental-SfM tests
(tests/test_sfm_incremental.py:92-214) run through the port.

The parity runs give the port JAX's sample ranks: a subclass replays the
JAX driver's key chain through the port's one draw method ``_draw``
(``jax.random.split`` as ``_next_key`` does, then ``split(sub, B)`` and
``randint`` per row for a batch, as twoview.py:357 and pnp.py:142 do).
The scene is make_multiview(seed 7, 80 points, 5 cameras, 0.3 px): no
outliers, so every PnP row is an inlier and the refined pose does not
depend on which hypothesis won (the DLT's sign quirk, pnp.py's
docstring).

Tolerances. Before any BA: the seed pair equal, its R2 and t2 within
1e-4, the same points accepted (their X within 1e-4 x their depth), the
same registration order, inlier counts equal, each registered pose
within 1e-4 and the same track set after each ``register_next``. From
one state (JAX's, loaded into both drivers): ``as_ba_problem`` equal
field for field with rotation vectors within 1e-6, and
``local_ba(window=3)`` with the same cameras, the same fixed mask and
costs within 1e-4 relative (two anchor cameras fix its gauge). After a
BA with camera 0 fixed only, the scale gauge is free and f32 rounding
moves along it (ROADMAP C), so cameras are held after a similarity
alignment: centers within 1e-3 x the trajectory's extent, ATE < 0.05 for
both.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from popsift_tpu.sfm import incremental as JI
from popsift_tpu_torch.sfm import incremental as TI
from popsift_tpu_torch.sfm.checkpoint import load_reconstruction
from popsift_tpu_torch.sfm.evaluate import ate_rmse, umeyama
from popsift_tpu_torch.tools.sfm_scenes import (INTR, camera_centers,
                                                make_multiview,
                                                tracks_from_gt)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS, N_CAMS = 80, 5


def jax_ranks(key, valid: np.ndarray, n_hyp: int, m: int) -> np.ndarray:
    """JAX's sample ranks for ``valid`` [N] (one RANSAC) or [B, N] (a
    batch, one split key a row)."""
    if valid.ndim == 1:
        return np.asarray(jax.random.randint(
            key, (n_hyp, m), 0, max(int(valid.sum()), 1)))
    keys = jax.random.split(key, len(valid))
    return np.stack([jax_ranks(k, v, n_hyp, m) for k, v in zip(keys, valid)])


class Replay(TI.IncrementalSfM):
    """The port's driver drawing JAX's ranks: the key chain of the JAX
    driver's ``_next_key``, one split a device call."""

    def __init__(self, *args, seed=0, **kw):
        super().__init__(*args, seed=seed, **kw)
        self.key = jax.random.PRNGKey(seed)

    def _draw(self, valid, n_hyp, min_set):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax_ranks(
            sub, valid.cpu().numpy(), n_hyp, min_set))).to(valid.device)


def recorded(base):
    """``base`` with each PnP chunk's results logged: {image: (R, t,
    n_inliers)} per device call, in ``pnp_log``."""
    class Recorded(base):
        def _pnp_eval_chunk(self, imgs):
            res = super()._pnp_eval_chunk(imgs)
            self.__dict__.setdefault("pnp_log", []).append(
                dict(zip(imgs, res)))
            return res
    return Recorded


def scene(seed=7, n_pts=N_PTS, noise=0.3):
    rng = np.random.default_rng(seed)
    X, cams, kps = make_multiview(rng, n_pts=n_pts, n_cams=N_CAMS,
                                  noise=noise)
    return cams, tracks_from_gt(kps, n_pts)


def state(drv) -> dict:
    """A copy of a driver's reconstruction."""
    return dict(cam_R={k: np.array(v) for k, v in drv.rec.cam_R.items()},
                cam_t={k: np.array(v) for k, v in drv.rec.cam_t.items()},
                points={int(t): np.array(v) for t, v in
                        drv.rec.points.items()},
                registered=list(drv.rec.registered))


def from_state(cls, tracks, st, **kw):
    """A fresh driver of ``cls`` holding the reconstruction ``st``."""
    drv = cls(tracks, INTR, **kw)
    drv.rec.cam_R = {k: v.copy() for k, v in st["cam_R"].items()}
    drv.rec.cam_t = {k: v.copy() for k, v in st["cam_t"].items()}
    drv.rec.points = {t: v.copy() for t, v in st["points"].items()}
    drv.rec.registered = list(st["registered"])
    drv._sync_from_rec()
    return drv


def run(drv) -> dict:
    """initialize, register until done (the track set after each call),
    the state before the final BA, then global_ba(iters=8)."""
    out = {"pair": drv.initialize()}
    a, b = out["pair"]
    out["R2"], out["t2"] = np.array(drv.rec.cam_R[b]), np.array(
        drv.rec.cam_t[b])
    out["init_points"] = state(drv)["points"]
    out["tracks"] = []
    while drv.register_next() is not None:
        out["tracks"].append(sorted(drv.rec.points))
    out["pnp_log"] = drv.pnp_log
    out["state"] = state(drv)
    out["costs"] = np.asarray(drv.global_ba(iters=8))
    out["centers"] = camera_centers(drv.rec, range(N_CAMS))
    out["registered"] = list(drv.rec.registered)
    return out


@pytest.fixture(scope="module")
def runs():
    cams, tracks = scene()
    want = run(recorded(JI.IncrementalSfM)(tracks, INTR))
    got = run(recorded(Replay)(tracks, INTR, device="cpu"))
    return cams, tracks, want, got


def test_seed_pair_matches_jax(runs):
    _, _, want, got = runs
    assert got["pair"] == want["pair"]
    np.testing.assert_allclose(got["R2"], want["R2"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t2"], want["t2"], rtol=0, atol=1e-4)
    assert sorted(got["init_points"]) == sorted(want["init_points"])
    for t, Xw in want["init_points"].items():
        np.testing.assert_allclose(got["init_points"][t], Xw, rtol=0,
                                   atol=1e-4 * np.linalg.norm(Xw))


def test_registrations_match_jax(runs):
    """The same order, inlier counts and poses (before any BA), and the
    same track set after each ``register_next``."""
    _, _, want, got = runs
    assert got["registered"] == want["registered"]
    assert len(got["registered"]) == N_CAMS
    assert got["tracks"] == want["tracks"]
    assert len(got["pnp_log"]) == len(want["pnp_log"])
    for g, w in zip(got["pnp_log"], want["pnp_log"]):
        assert list(g) == list(w)
        for img, (R, t, n) in w.items():
            assert g[img][2] == n
            np.testing.assert_allclose(g[img][0], R, rtol=0, atol=1e-4)
            np.testing.assert_allclose(g[img][1], t, rtol=0, atol=1e-4)


def test_global_ba_matches_jax_after_alignment(runs):
    cams, _, want, got = runs
    gt = camera_centers(cams, range(N_CAMS))
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    s, R, t = umeyama(got["centers"], want["centers"])
    aligned = got["centers"] @ (s * R).T + t
    gap = np.linalg.norm(aligned - want["centers"], axis=1).max()
    assert gap <= 1e-3 * extent, (gap, extent)
    for r in (got, want):
        assert ate_rmse(r["centers"], gt) < 0.05
        assert r["costs"][-1] <= r["costs"][0]


def test_as_ba_problem_matches_jax(runs):
    """The same state in both drivers packs to the same problem."""
    _, tracks, want, _ = runs
    jd = from_state(JI.IncrementalSfM, tracks, want["state"])
    td = from_state(TI.IncrementalSfM, tracks, want["state"], device="cpu")
    jp, jc, jt = jd.as_ba_problem()
    tp, tc, tt = td.as_ba_problem()
    assert tc == jc and tt == jt
    for name in jp._fields:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        if name == "cams":
            np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=0, atol=1e-6)
            a, b = a[:, 3:], b[:, 3:]
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_local_ba_matches_jax(runs):
    """One local_ba(window=3) from the same state: the same cameras and
    fixed mask (two anchors), costs within 1e-4 relative."""
    _, tracks, want, _ = runs
    problems = {}

    def spy(base, key):
        class Spy(base):
            def as_ba_problem(self, *a, **kw):
                out = super().as_ba_problem(*a, **kw)
                problems[key] = (out[1], np.asarray(kw["fixed_mask"]))
                return out
        return Spy

    jd = from_state(spy(JI.IncrementalSfM, "jax"), tracks, want["state"])
    td = from_state(spy(TI.IncrementalSfM, "torch"), tracks, want["state"],
                    device="cpu")
    jcost = np.asarray(jd.local_ba(window=3))
    tcost = td.local_ba(window=3).numpy()
    assert problems["torch"][0] == problems["jax"][0]
    assert np.array_equal(problems["torch"][1], problems["jax"][1])
    assert problems["jax"][1].sum() == 2
    np.testing.assert_allclose(tcost, jcost, rtol=1e-4)
    assert tcost[-1] <= tcost[0]


def test_draws_go_through_the_draw_method():
    """Every RANSAC of the driver takes its ranks from ``_draw``: a run
    whose draws are counted makes one per device call, and the same seed
    draws the same ranks."""
    _, tracks = scene()
    calls = []

    class Counted(TI.IncrementalSfM):
        def _draw(self, valid, n_hyp, min_set):
            r = super()._draw(valid, n_hyp, min_set)
            calls.append(r)
            return r

    drv = Counted(tracks, INTR, device="cpu", seed=3)
    drv.initialize()
    while drv.register_next() is not None:
        pass
    shapes = [tuple(r.shape) for r in calls]
    assert shapes[:8] == [(512, 8)] * 8          # the top_k seed pairs
    assert shapes[8:] and all(s == (16, 256, 6) for s in shapes[8:])
    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 2 ** 31 - 1, (512, 8), generator=gen)
    assert torch.equal(calls[0], raw % 80)


def test_device_defaults_to_cuda():
    _, tracks = scene()
    if torch.cuda.is_available():
        assert TI.IncrementalSfM(tracks, INTR).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TI.IncrementalSfM(tracks, INTR)


# ---------------------------------------------------------------------------
# ports of the JAX package's incremental tests, run with the port's own
# generator
# ---------------------------------------------------------------------------

def test_incremental_reconstruction_and_ate(tmp_path):
    """Port of tests/test_sfm_incremental.py:92-120."""
    cams, tracks = scene()
    sfm = TI.IncrementalSfM(tracks, INTR, checkpoint_dir=str(tmp_path / "ck"),
                            device="cpu")
    pair = sfm.initialize()
    assert pair is not None
    while sfm.register_next() is not None:
        pass
    assert len(sfm.rec.registered) == N_CAMS
    sfm.global_ba(iters=8)
    rmse = ate_rmse(camera_centers(sfm.rec, range(N_CAMS)),
                    camera_centers(cams, range(N_CAMS)))
    assert rmse < 0.05, f"ATE {rmse}"

    # checkpoint/resume: latest checkpoint reproduces the state
    rec2 = load_reconstruction(str(tmp_path / "ck"))
    assert rec2.registered == sfm.rec.registered
    np.testing.assert_allclose(rec2.cam_t[2], sfm.rec.cam_t[2], atol=1e-6)
    assert len(rec2.points) == len(sfm.rec.points)


def test_fault_injection_resume(tmp_path):
    """Port of tests/test_sfm_incremental.py:123-182: kill a run
    mid-registration (subprocess hard exit; the subprocess imports only
    torch and the port), resume from LATEST, and converge to the
    uninterrupted run's reconstruction."""
    ck = str(tmp_path / "ck")
    driver = f"""
import os, sys
sys.path.insert(0, {REPO!r})
import numpy as np
from popsift_tpu_torch.sfm.incremental import IncrementalSfM
from popsift_tpu_torch.tools.sfm_scenes import (INTR, make_multiview,
                                                tracks_from_gt)
rng = np.random.default_rng(7)
X, cams, kps = make_multiview(rng, n_pts=60, n_cams=5, noise=0.0)
tracks = tracks_from_gt(kps, 60)
sfm = IncrementalSfM(tracks, INTR, checkpoint_dir={ck!r}, device="cpu")
sfm.initialize()
sfm.register_next()
# simulated crash mid-run: no cleanup, no final BA (18: jax was loaded)
os._exit(18 if "jax" in sys.modules else 17)
"""
    p = subprocess.run([sys.executable, "-c", driver], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 17, p.stderr[-3000:]
    assert os.path.exists(os.path.join(ck, "LATEST"))

    # resume from the crash point and finish
    _, tracks = scene(n_pts=60, noise=0.0)
    sfm = TI.IncrementalSfM.resume(tracks, ck, device="cpu")
    assert len(sfm.rec.registered) == 3     # init pair + 1 registration
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    assert len(sfm.rec.registered) == N_CAMS

    # reference: uninterrupted run on the same scene
    ref = TI.IncrementalSfM(tracks, INTR, device="cpu")
    ref.initialize()
    while ref.register_next() is not None:
        pass
    ref.global_ba(iters=8)
    np.testing.assert_allclose(camera_centers(sfm.rec, range(N_CAMS)),
                               camera_centers(ref.rec, range(N_CAMS)),
                               atol=1e-3)
    assert len(sfm.rec.points) == len(ref.rec.points)


def test_refine_culls_corrupted_points():
    """Port of tests/test_sfm_incremental.py:185-214: refinement (BA ->
    cull -> retriangulate -> BA) removes planted gross structure errors
    and restores them by retriangulation, keeping the ATE bound."""
    cams, tracks = scene(seed=9)
    sfm = TI.IncrementalSfM(tracks, INTR, device="cpu")
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    n_before = len(sfm.rec.points)

    # corrupt 10 reconstructed points
    bad = list(sfm.rec.points)[:10]
    for tr in bad:
        sfm.rec.points[tr] = sfm.rec.points[tr] + np.float32(3.0)
    assert sfm.cull_points(max_err_px=4.0) >= 8   # detects the damage

    sfm.refine(rounds=2)
    assert len(sfm.rec.points) >= n_before - 2
    assert ate_rmse(camera_centers(sfm.rec, range(N_CAMS)),
                    camera_centers(cams, range(N_CAMS))) < 0.05
