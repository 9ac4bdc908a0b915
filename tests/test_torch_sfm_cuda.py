"""SfM on the card: the geometry (``sfm/ba.py``, ``sfm/pnp.py``), the
drivers (``sfm/incremental.py``, ``sfm/global_sfm.py``) and popsift-sfm
(``cli/sfm.py``, ``sfm/retrieval.py``), each against the port's run on
the CPU or the scene's truth.

These tests need a CUDA device; they skip without one. On the card:

    python -m pytest tests/test_torch_sfm_cuda.py -q --noconftest -m cuda

Sizes: the geometry at the repo's BA benchmark problem (100 cameras on
an arc round 40,000 points, each seen by 5 of them, f = 500 on 640 x
480, ``tools/sfm_scenes.py::ba_scene``) and PnP at ``IncrementalSfM``'s
batch shape (16 images x 2048 rows); the drivers at the JAX tests'
sequence sizes (tests/test_sfm_scale.py, tests/test_global_sfm.py);
popsift-sfm on the scene of the JAX package's E2E artifact
(``tools/e2e_proof.py::render_sequence``: 100 frames of 240 x 320).
The f32 GN step and the 24-node translation solves are held by the
rules ``tools/step_spread.py`` explains.
"""

import contextlib
import os
import re
import statistics

import numpy as np
import pytest
import torch

from popsift_tpu_torch.sfm import ba as B
from popsift_tpu_torch.sfm import evaluate as E
from popsift_tpu_torch.sfm import global_sfm as G
from popsift_tpu_torch.sfm import incremental as I
from popsift_tpu_torch.sfm import pnp as P
from popsift_tpu_torch.tools import sfm_scenes as S
from popsift_tpu_torch.tools.step_spread import (TRANSLATION_F32_TOL, as_f64,
                                                 gn_step_gaps, gn_steps,
                                                 step_scene, translation_gaps)
from torch_card import PAIR_NEAR_TIE, card_device, without_syncs

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
PNP_THRESH = 2e-4            # IncrementalSfM's gate (incremental.py:122)
INC_CAMS, INC_POINTS = 200, 1200     # test_sequence_reconstruction_200_cams
LOCAL_CAMS = 80                      # test_local_ba_windowed_sequence
GLOBAL_CAMS = 40                     # test_global_sfm_end_to_end
# popsift-sfm on E2E_r05.json's scene (scripts/e2e_proof.py)
E2E_FRAMES, E2E_HW = 100, (240, 320)
E2E_TOP_M = 8                  # --retrieval 8, as the artifact's command
# The scene's ATE is a chaotic function of rounding and draws (ROADMAP C):
# popsift_tpu.cli.sfm with this command on a CPU registers 100 and ends at
# 5.47 % of the trajectory (its seed-0 draws; the artifact's 3.11 % is not
# reproduced; its driver from seeds 1-4 ends at 1.7-3.3 %), and the port's
# runs spread from 1.2 % to 23 % on the card, a seventh of them past 10.9 %.
# One run would test the draw, so the run is made from E2E_SEEDS draws
# (--seed) and their medians are gated: at least 98 registered, ATE at most
# twice JAX's or 5 %, whichever is larger (the rule of the --global check)
E2E_SEEDS = (0, 1, 2, 3, 4, 5, 6)
E2E_MIN_REGISTERED = 98
JAX_E2E_ATE_PCT = 5.471
E2E_MAX_ATE_PCT = max(2 * JAX_E2E_ATE_PCT, 5.0)
GLOBAL_E2E_FRAMES = 40         # the driver test's global_sfm size
# popsift_tpu.cli.sfm --global --retrieval 8 --min-covis 30 on the first 40
# frames, on a CPU (PERF.md §6): every camera, ATE 0.016431. Its
# global_sfm from seeds 0-5 on those tracks ends either near that (1.1-1.6
# % of the trajectory) or collapsed (27-29 %), three times each, and the
# port's runs split the same way; so --global runs from GLOBAL_SEEDS and
# the best ATE is gated, with the median registered count
GLOBAL_SEEDS = (0, 1, 2, 3, 4, 5, 6)
JAX_GLOBAL_REGISTERED, JAX_GLOBAL_ATE = 40, 0.016431
CLI_PARITY_FRAMES = 6


@pytest.fixture(scope="module")
def dev():
    return card_device("these sizes run on the card")


def _cost(p) -> float:
    return float(B.robust_cost(B.residuals(p)))


def _ate_of(cams, cams_gt) -> float:
    return E.ate_rmse(E.camera_centers(cams.cpu().numpy()),
                      E.camera_centers(cams_gt))


def _extent(C: np.ndarray) -> float:
    return float(np.linalg.norm(C.max(0) - C.min(0)))


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "cg"])
def test_gn_step_equals_the_cpu(dev, kind):
    """One ``schur_dense_step`` / ``schur_cg_step`` on the card against
    the port on the CPU (``step_scene``): in f64 dc and dp within 1e-9 x
    the step's max; in f32 the cost within 1e-5 relative and the step
    within 1e-3 of the f64 step in the GN model's norm, finite; the step
    queues without a host synchronisation."""
    pc, pd = (B.problem_from_numpy(step_scene(), d) for d in (CPU, dev))
    p64, pd64 = as_f64(pc), as_f64(pd)
    lam = {d: torch.full((), 1e-3, device=d) for d in (CPU, dev)}
    assert B.dense_schur_feasible(S.BA_CAMS, S.BA_POINTS)
    jac = (*B._jacobians(p64), pc.obs_cam, pc.obs_pt)
    step = gn_steps()[kind]
    ref = step(pc, lam[CPU])
    exact = step(p64, lam[CPU].double())
    got = step(pd, lam[dev])
    g = gn_step_gaps(got, step(pd64, lam[dev].double()), ref, exact, jac,
                     1e-3)
    assert all(v <= 1e-9 for v in g["f64_card_cpu"].values()), g
    assert abs(float(got[2]) - float(ref[2])) / float(ref[2]) <= 1e-5
    assert g["h_norm"]["card_f64"] <= 1e-3, g
    assert all(torch.isfinite(a).all() for a in got[:2])
    without_syncs(lambda: step(pd, lam[dev]))


@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["dense", "cg"])
def test_bundle_adjust(dev, kind, noise):
    """``bundle_adjust(iters=10)`` on ``ba_scene(2)``: without noise below
    1e-4 of the start cost; with 0.5 px noise the ATE at most 1e-3 x the
    trajectory's extent and the final cost within 1e-3 of the CPU's."""
    kw = dict() if kind == "dense" else dict(dense=False, cg_iters=25)
    fields, cams_gt = S.ba_scene(2, noise_px=noise)
    pd = B.problem_from_numpy(fields, dev)
    cost0 = _cost(pd)
    C = E.camera_centers(cams_gt)
    extent = float(np.linalg.norm(C.max(0) - C.min(0)))
    res, costs = B.bundle_adjust(pd, iters=10, **kw)
    cost1 = _cost(res)
    assert torch.isfinite(costs).all()
    if noise == 0.0:
        assert cost1 < 1e-4 * cost0, (cost0, cost1)
        return
    assert _ate_of(res.cams, cams_gt) <= 1e-3 * extent
    ref, _ = B.bundle_adjust(B.problem_from_numpy(fields, CPU), iters=10,
                             **kw)
    ref_cost = _cost(ref)
    assert abs(cost1 - ref_cost) / ref_cost <= 1e-3


def test_huber_against_outliers(dev):
    """5 % of the observations 80 px off: Huber (delta 1) on both paths
    ends under a tenth of L2's ATE, its cost not rising."""
    fields, cams_gt = S.ba_scene(3, noise_px=0.3, outliers=0.05)
    pd = B.problem_from_numpy(fields, dev)
    ate_l2 = _ate_of(B.bundle_adjust(pd, iters=10)[0].cams, cams_gt)
    for kw in (dict(), dict(dense=False, cg_iters=25)):
        res, costs = B.bundle_adjust(pd, iters=10, huber_delta=1.0, **kw)
        assert float(costs[-1]) <= float(costs[0])
        assert _ate_of(res.cams, cams_gt) < ate_l2 / 10, kw


def test_shared_focal_equals_the_cpu(dev):
    """The joint focal solve on tests/test_sfm.py's 8-camera scene: the
    card within 0.5 % of the true focal, 1e-4 of the CPU's, the final
    cost within 1e-3 of the CPU's, the principal point untouched."""
    ffields, f_true = S.focal_scene()
    focal = {}
    for d in (CPU, dev):
        res, costs = B.bundle_adjust(B.problem_from_numpy(ffields, d),
                                     iters=20, opt_intr=True,
                                     intr_mask=(1.0, 1.0, 0.0, 0.0))
        focal[d.type] = (res.intr.cpu().numpy(), float(costs[-1]))
    (fi_d, c_d), (fi_c, c_c) = focal[dev.type], focal["cpu"]
    assert float(np.abs(fi_d[:2] - f_true).max() / f_true) < 0.005
    assert float(np.abs(fi_d - fi_c).max() / f_true) <= 1e-4
    assert abs(c_d - c_c) <= 1e-3 * c_c
    assert np.array_equal(fi_d[2:], ffields["intr"][2:].astype(np.float32))


@pytest.mark.parametrize("kind", ["dense", "cg"])
def test_bundle_adjust_does_not_synchronize(dev, kind):
    """``bundle_adjust(iters=10)`` at the benchmark problem's size runs
    under sync debug mode "error"."""
    kw = dict() if kind == "dense" else dict(dense=False, cg_iters=25)
    fields, _ = S.ba_scene(2, noise_px=0.5)
    pd = B.problem_from_numpy(fields, dev)
    B.bundle_adjust(pd, iters=10, **kw)
    without_syncs(lambda: B.bundle_adjust(pd, iters=10, **kw))


def test_ransac_pnp_batch(dev):
    """``ransac_pnp_batch`` at ``IncrementalSfM``'s shape (16 images x
    2048 rows, about 1500 valid, a quarter outliers), on the card against
    the CPU from the same ranks: R within 1e-4 and t within 1e-4 x |t|,
    or within the spread of the CPU's own poses over two more rank draws
    (the refinement fits the winning hypothesis's inliers, and the
    card's SVDs give some null vectors the other sign, pnp.py's
    docstring); the inlier masks equal off the gate's 1 % band and on at
    least 99.9 % of the valid rows; the pose within 1e-3 rad and 1e-3 x
    the median depth of the truth."""
    X, x, valid, truth, R_gt, t_gt, depth = S.pnp_scene(4)
    B_ = X.shape[0]
    ranks = P.draw_ranks(torch.Generator().manual_seed(5), valid, 256, 6)
    args = dict(thresh=PNP_THRESH, n_hyp=256, refine_iters=10)
    ref = P.ransac_pnp_batch(None, X, x, valid, ranks=ranks, **args)
    got = P.PnPResult(*(a.cpu() for a in P.ransac_pnp_batch(
        None, X.to(dev), x.to(dev), valid.to(dev), ranks=ranks.to(dev),
        **args)))

    def pose_gap(a, b):
        return (float((a.R - b.R).abs().max()),
                float(((a.t - b.t).norm(dim=1) / b.t.norm(dim=1)).max()))

    spread = [pose_gap(P.ransac_pnp_batch(
        torch.Generator().manual_seed(seed), X, x, valid, **args), ref)
        for seed in (6, 7)]
    R_tol = max(1e-4, max(g[0] for g in spread))
    t_tol = max(1e-4, max(g[1] for g in spread))
    R_err, t_err = pose_gap(got, ref)
    assert R_err <= R_tol and t_err <= t_tol, (R_err, t_err, R_tol, t_tol)
    # rows whose error under the CPU's pose lies within 1 % of the gate may
    # fall either side
    e_ref = torch.stack([P.reprojection_error2(ref.R[b:b + 1],
                                               ref.t[b:b + 1], X[b], x[b])[0]
                         for b in range(B_)])
    near = (e_ref - PNP_THRESH).abs() <= 0.01 * PNP_THRESH
    differ = got.inliers != ref.inliers
    assert not (differ & ~near).any()
    assert int(differ.sum()) <= 1e-3 * int(valid.sum())
    ang = [float(np.arccos(np.clip((np.trace(R_gt[b] @ got.R[b].double()
                                             .numpy().T) - 1) / 2, -1, 1)))
           for b in range(B_)]
    # translation against the scene's scale: the inliers' 1e-3 noise puts
    # |t - t_true| at 0.5-3.5e-3 for points 4-8 deep
    terr = [float(np.linalg.norm(got.t[b].double().numpy() - t_gt[b])
                  / depth[b]) for b in range(B_)]
    assert max(ang) <= 1e-3 and max(terr) <= 1e-3, (max(ang), max(terr))


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def _recording(base):
    """``base`` (the port's IncrementalSfM) logging the ranks of every
    draw (``ranks``) and each PnP chunk's (image, n_inliers) (``inl``)."""
    class Recording(base):
        def _draw(self, valid, n_hyp, min_set):
            r = super()._draw(valid, n_hyp, min_set)
            self.__dict__.setdefault("ranks", []).append(r.cpu())
            return r

        def _pnp_eval_chunk(self, imgs):
            res = super()._pnp_eval_chunk(imgs)
            self.__dict__.setdefault("inl", []).extend(
                (img, n) for img, (_, _, n) in zip(imgs, res))
            return res
    return Recording


def _aligned_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest distance between ``b`` and ``a`` after the similarity
    (Umeyama) that best maps ``a`` onto ``b``."""
    s, R, t = E.umeyama(a.astype(np.float64), b.astype(np.float64))
    return float(np.linalg.norm(a @ (s * R).T + t - b, axis=1).max())


def test_incremental_equals_the_cpu(dev):
    """``IncrementalSfM`` on the card against its CPU run, 5 cameras / 80
    points (seed 7, 0.3 px): the generator lives on the host, so both
    draw the same ranks; the same seed pair with R2 / t2 within 1e-4, the
    same registration order and inlier counts, and after
    ``global_ba(iters=8)`` the centers within 1e-3 x the extent after a
    similarity alignment, ATE < 0.05 on both."""
    _, cams, kps = S.make_multiview(np.random.default_rng(7), 80, 5, 0.3)
    tracks = S.tracks_from_gt(kps, 80)
    gt = S.camera_centers(cams, range(5))
    runs = {}
    for d in (dev, CPU):
        drv = _recording(I.IncrementalSfM)(tracks, S.INTR, device=d)
        pair = drv.initialize()
        R2, t2 = drv.rec.cam_R[pair[1]].copy(), drv.rec.cam_t[pair[1]].copy()
        while drv.register_next() is not None:
            pass
        drv.global_ba(iters=8)
        C = S.camera_centers(drv.rec, range(5))
        runs[d.type] = dict(pair=pair, R2=R2, t2=t2, inl=drv.inl,
                            order=list(drv.rec.registered), ranks=drv.ranks,
                            C=C, ate=E.ate_rmse(C, gt))
    a, b = runs[dev.type], runs["cpu"]
    assert len(a["ranks"]) == len(b["ranks"])
    assert all(torch.equal(x, y) for x, y in zip(a["ranks"], b["ranks"]))
    assert a["pair"] == b["pair"]
    assert max(float(np.abs(a["R2"] - b["R2"]).max()),
               float(np.abs(a["t2"] - b["t2"]).max())) <= 1e-4
    assert a["order"] == b["order"] and a["inl"] == b["inl"]
    assert _aligned_gap(a["C"], b["C"]) / _extent(gt) <= 1e-3
    assert a["ate"] < 0.05 and b["ate"] < 0.05


def test_incremental_200_cameras(dev):
    """``IncrementalSfM`` at 200 cameras / 1200 points (seed 13, 0.2 px,
    ``ba_every=25, register_batch=8``): at least 196 registered, the
    final BA's cost not rising, ATE < 0.5."""
    rng = np.random.default_rng(13)
    _, cams, kps, vis = S.make_sequence(rng, n_pts=INC_POINTS,
                                        n_cams=INC_CAMS, noise=0.2)
    sfm = I.IncrementalSfM(S.tracks_from_vis(kps, vis), S.INTR, ba_every=25,
                           register_batch=8, device=dev)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    costs = sfm.global_ba(iters=8)
    reg = sorted(sfm.rec.registered)
    assert len(reg) >= INC_CAMS - 4
    assert costs[-1] <= costs[0], costs
    assert E.ate_rmse(S.camera_centers(sfm.rec, reg),
                      S.camera_centers(cams, reg)) < 0.5


def test_local_ba_80_cameras(dev):
    """Windowed local BA at 80 cameras (window 12): at least 76
    registered, ATE under 1 % of the extent, also after ``refine(2)``."""
    rng = np.random.default_rng(13)
    _, cams, kps, vis = S.make_sequence(rng, n_cams=LOCAL_CAMS, noise=0.2,
                                        span=0.25 * LOCAL_CAMS + 10,
                                        vis_pts=240)
    sfm = I.IncrementalSfM(S.tracks_from_vis(kps, vis), S.INTR, ba_every=50,
                           register_batch=8, local_ba_window=12, device=dev)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    reg = sorted(sfm.rec.registered)
    C_gt = S.camera_centers(cams, reg)
    ate = E.ate_rmse(S.camera_centers(sfm.rec, reg), C_gt)
    sfm.refine(rounds=2)
    ate_r = E.ate_rmse(S.camera_centers(sfm.rec, reg), C_gt)
    assert len(reg) >= LOCAL_CAMS - 4
    assert ate < 0.01 * _extent(C_gt) and ate_r < 0.01 * _extent(C_gt)


def test_global_sfm_40_cameras(dev):
    """``global_sfm`` at 40 cameras: all registered, ATE < 0.5."""
    rng = np.random.default_rng(2)
    _, cams, kps, vis = S.make_sequence(rng, n_cams=GLOBAL_CAMS)
    drv = G.global_sfm(S.tracks_from_vis(kps, vis), S.INTR, min_covis=30,
                       max_edges=120, device=dev)
    reg = sorted(drv.rec.registered)
    assert len(reg) == GLOBAL_CAMS
    assert E.ate_rmse(S.camera_centers(drv.rec, reg),
                      S.camera_centers(cams, reg)) < 0.5


def test_averaging_solvers(dev):
    """``translation_averaging_cg`` at 12,000 nodes (median error under 5
    % of the spread after a similarity); the dense and CG solves of the
    24-node problem against each other (1e-2 x the scale) and against
    their CPU runs and the f64 solve (``TRANSLATION_F32_TOL`` x the
    scale); rotation averaging of 30 nodes (median error under 0.5 deg,
    max under 3)."""
    rot, small, big = S.averaging_problems()
    n, ei, ej, d, C_gt = big
    C = G.translation_averaging_cg(
        n, *[torch.from_numpy(x).to(dev) for x in (ei, ej, d)], iters=2,
        cg_iters=80)[0].cpu().numpy()
    s, R, t = E.umeyama(C.astype(np.float64), C_gt.astype(np.float64))
    errs = np.linalg.norm(C @ (s * R).T + t - C_gt, axis=1)
    spread = float(np.linalg.norm(C_gt - C_gt.mean(0), axis=1).mean())
    assert np.isfinite(C).all() and np.median(errs) < 0.05 * spread

    res, gaps = translation_gaps(small, dev)
    scale = float(np.linalg.norm(res["dense"] - res["dense"].mean(0),
                                 axis=1).mean())
    assert float(np.linalg.norm(res["cg"] - res["dense"], axis=1).max()) \
        / scale < 1e-2
    for kind, g in gaps.items():
        assert g["card_cpu"] <= TRANSLATION_F32_TOL, (kind, g)
        assert g["card_f64"] <= TRANSLATION_F32_TOL, (kind, g)

    n, ei, ej, R_rel, R_gt = rot
    R = G.rotation_averaging(n, *[torch.from_numpy(x).to(dev) for x in
                                  (ei, ej, R_rel)])[0].cpu().numpy()
    R_ref = np.einsum("nab,cb->nac", R_gt, R_gt[0])
    cos = (np.einsum("nab,nab->n", R.astype(np.float64), R_ref) - 1) / 2
    errs = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert np.median(errs) < 0.5 and errs.max() < 3.0


def test_checkpoint_and_resume(dev, tmp_path):
    """A run stopped after one ``register_next`` and resumed from its
    checkpoint on the card (test_fault_injection_resume): 3 registered at
    the resume, all 5 at the end, centers within 1e-3 of an uninterrupted
    run, the same point count."""
    _, cams, kps = S.make_multiview(np.random.default_rng(7), 60, 5, 0.0)
    tracks = S.tracks_from_gt(kps, 60)
    ck = str(tmp_path)
    first = I.IncrementalSfM(tracks, S.INTR, checkpoint_dir=ck, device=dev)
    first.initialize()
    first.register_next()
    del first                         # the run stops here
    sfm = I.IncrementalSfM.resume(tracks, ck, device=dev)
    n_resumed = len(sfm.rec.registered)
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    ref = I.IncrementalSfM(tracks, S.INTR, device=dev)
    ref.initialize()
    while ref.register_next() is not None:
        pass
    ref.global_ba(iters=8)
    gap = float(np.abs(S.camera_centers(sfm.rec, range(5))
                       - S.camera_centers(ref.rec, range(5))).max())
    assert n_resumed == 3 and len(sfm.rec.registered) == 5
    assert gap <= 1e-3
    assert len(sfm.rec.points) == len(ref.rec.points)


# ---------------------------------------------------------------------------
# popsift-sfm, images to model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def e2e(dev, tmp_path_factory):
    """The E2E scene's frames written as PGM, their intrinsics flags, the
    true poses and the frames' strongest descriptors extracted on the
    card, as the CLI takes them."""
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.eval.repeatability import \
        strongest_descriptor_per_keypoint
    from popsift_tpu_torch.io.image import write_pgm
    from popsift_tpu_torch.tools.e2e_proof import render_sequence
    frames, gt, (fx, fy, cx, cy) = render_sequence(E2E_FRAMES, *E2E_HW)
    work = str(tmp_path_factory.mktemp("e2e"))
    paths = []
    for i, fr in enumerate(frames):
        paths.append(os.path.join(work, f"frame_{i:04d}.pgm"))
        write_pgm(paths[-1], fr)
    ps = PopSift(SiftConfig(), device=dev)
    jobs = [ps.enqueue(fr) for fr in frames]
    descs = {i: strongest_descriptor_per_keypoint(j.get())[1]
             for i, j in enumerate(jobs)}
    intr = ["--fx", str(fx), "--fy", str(fy), "--cx", str(cx), "--cy",
            str(cy)]
    return dict(paths=paths, gt=gt, intr=intr, work=work, descs=descs)


def _run_cli(argv: list) -> tuple:
    """(exit code, printed lines) of one in-process popsift-sfm run."""
    import io

    from popsift_tpu_torch.cli import sfm as sfm_cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sfm_cli.main(argv)
    return rc, out.getvalue().splitlines()


def _cli_counts(lines: list) -> dict:
    """The per-image keypoint counts, per-pair match counts and the track
    count a ``-v`` popsift-sfm run printed."""
    num = lambda l: int(re.search(r": (\d+)", l).group(1))
    return {"keypoints": [num(l) for l in lines if l.startswith("image ")],
            "pairs": {l.split(":")[0]: num(l) for l in lines
                      if l.startswith("pair (")},
            "tracks": [num(l) for l in lines if l.startswith("tracks:")]}


def test_retrieval_equals_the_cpu(dev, e2e):
    """``train_codebook``, ``build_signatures`` and ``pair_shortlist`` of
    the frames' descriptors on the card against the CPU from the same
    sample and init scores: centers within 1e-4 x the largest entry,
    signatures within 1e-5, the shortlist equal pair for pair; ``top_k``
    breaks ties toward the lower index on the card."""
    from popsift_tpu_torch.sfm import retrieval as R
    descs = e2e["descs"]
    res = {}
    for d in (dev, CPU):
        c = R.train_codebook(descs, device=d)
        s = R.build_signatures(descs, device=d)
        res[d.type] = (c.cpu(), s.cpu(), R.pair_shortlist(
            s, top_m=E2E_TOP_M, device=d))
    (cc, sc, pc), (cr, sr, pr) = res[dev.type], res["cpu"]
    assert float((cc - cr).abs().max() / cr.abs().max()) <= 1e-4
    assert float((sc - sr).abs().max()) <= 1e-5
    assert pc == pr
    vals = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0, -0.0, 0.0, 3.0])
    assert R.top_k(vals.to(dev), 8).cpu().tolist() == [1, 2, 4, 7, 0, 3, 6,
                                                       5]


def test_images_to_model(dev, e2e):
    """``popsift-sfm --device cuda --retrieval 8 --refine`` on the 100
    frames from each of ``E2E_SEEDS``' draws: exit 0, the median of the
    seven runs at least ``E2E_MIN_REGISTERED`` registered and an ATE at
    most ``E2E_MAX_ATE_PCT`` % of the trajectory; the first run's COLMAP
    text export and PLY written."""
    from popsift_tpu_torch.tools.e2e_proof import ate_report
    work = e2e["work"]
    rec = os.path.join(work, "rec.npz")
    sparse, ply = os.path.join(work, "sparse"), os.path.join(work, "c.ply")
    runs = []
    for seed in E2E_SEEDS:
        extra = (["--export-colmap", sparse, "--export-ply", ply]
                 if seed == E2E_SEEDS[0] else [])
        rc, _ = _run_cli(["-i"] + e2e["paths"] + e2e["intr"] + [
            "--device", dev.type, "--retrieval", str(E2E_TOP_M), "--refine",
            "--seed", str(seed), "--export", rec, "-v", *extra])
        assert rc == 0, seed
        runs.append(ate_report(rec, e2e["gt"]))
        if extra:
            for f in ("cameras.txt", "images.txt", "points3D.txt"):
                assert os.path.getsize(os.path.join(sparse, f)) > 0, f
            assert os.path.getsize(ply) > 0
    assert statistics.median(r["registered"] for r in runs) \
        >= E2E_MIN_REGISTERED
    assert statistics.median(r["rmse_pct_of_traj"] for r in runs) \
        <= E2E_MAX_ATE_PCT


def test_global_cli(dev, e2e):
    """``popsift-sfm --global`` on the first 40 frames, the JAX CLI's
    command, from each of ``GLOBAL_SEEDS``' draws, held to the JAX CLI's
    result on a CPU: the median registered count at least JAX's minus 2,
    the best ATE at most twice JAX's or 5 % of the trajectory."""
    from popsift_tpu_torch.tools.e2e_proof import ate_report
    rec_g = os.path.join(e2e["work"], "rec_global.npz")
    gt = e2e["gt"][:GLOBAL_E2E_FRAMES]
    glob = []
    for seed in GLOBAL_SEEDS:
        rc, _ = _run_cli(["-i"] + e2e["paths"][:GLOBAL_E2E_FRAMES]
                         + e2e["intr"] + ["--device", dev.type, "--global",
                                          "--retrieval", str(E2E_TOP_M),
                                          "--min-covis", "30", "--seed",
                                          str(seed), "--export", rec_g,
                                          "-v"])
        assert rc == 0, seed
        glob.append(ate_report(rec_g, gt))
    max_ate = max(2 * JAX_GLOBAL_ATE, 0.05 * glob[-1]["trajectory_length"])
    assert statistics.median(g["registered"] for g in glob) \
        >= min(JAX_GLOBAL_REGISTERED, GLOBAL_E2E_FRAMES) - 2
    assert min(g["rmse"] for g in glob) <= max_ate


def test_cli_card_equals_the_cpu(dev, e2e):
    """The first 6 frames on the card and on the CPU with the same
    ``--seed``: equal keypoint and track counts, each pair's match count
    within ``PAIR_NEAR_TIE``, the same registered cameras."""
    runs = {}
    for d in (dev, CPU):
        r = os.path.join(e2e["work"], f"rec6_{d.type}.npz")
        rc, lines = _run_cli(["-i"] + e2e["paths"][:CLI_PARITY_FRAMES]
                             + e2e["intr"] + ["--device", d.type, "--seed",
                                              "3", "--export", r, "-v"])
        assert rc == 0, d
        runs[d.type] = dict(_cli_counts(lines), registered=sorted(
            int(c) for c in np.load(r)["registered"]))
    a, b = runs[dev.type], runs["cpu"]
    assert a["keypoints"] == b["keypoints"]
    assert a["tracks"] == b["tracks"]
    assert sorted(a["pairs"]) == sorted(b["pairs"])
    gaps = {p: abs(a["pairs"][p] - n) / max(n, 1)
            for p, n in b["pairs"].items()}
    assert max(gaps.values()) <= PAIR_NEAR_TIE, gaps
    assert a["registered"] == b["registered"]
