"""BAL problems in the port: ``sfm/ba.py``'s 9-wide camera model against
the plain float64 reference ``sfm/bal_reference.py``, the reference's
hand-written Jacobian against central differences, ``sfm/bal.py``'s file
format, ``tools/bal_scene.py``'s counts, and ``bundle_adjust``'s spans
and counters. CPU only, small problems.

Tolerances, and why:
- the reference's Jacobian within 1e-7 x its largest entry of f64
  central differences (step 1e-6: truncation ~1e-12, rounding ~1e-10 of
  pixel-sized values over the step);
- the program in f64 takes the reference's steps: no camera is fixed,
  so only what the similarity gauge leaves alone is compared. Each
  iteration's cost within 1e-8 relative (dense; the same damped system
  solved by LU on both sides, the program's Jacobi-scaled, seen at
  1.4e-9) and 1e-5 relative (CG, 60 iterations: the
  step converged to the f64 rounding of its camera directions);
  reprojections within 1e-6 px;
- in f32, the program's own precision (residuals, Jacobians and the
  state; the 9-wide step reduces and solves in f64): each iteration's
  cost within 5e-3 relative (seen up to 2.2e-3, at the first iteration
  of a problem whose first step lands near the noise floor, where the
  f32 residuals' rounding moves it), reprojections after 10 iterations
  within 5e-3 px (seen 6e-5 px). Where the cost has converged, the f32
  accept test decides on rounding; the costs differ by no more than
  that.
"""

import ast
import inspect
import os

import numpy as np
import pytest
import torch

from popsift_tpu_torch.sfm import ba as B
from popsift_tpu_torch.sfm import bal as BAL
from popsift_tpu_torch.sfm import bal_reference as REF
from popsift_tpu_torch.tools import bal_scene as SC
from popsift_tpu_torch.utils import profiling

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arc_problem(seed: int, n_cams: int = 6, n_points: int = 200,
                noise: float = 0.5):
    """A small BAL problem: cameras on an arc of radius 8 looking at
    points in a 4 x 4 x 4 cube, each point seen by every camera; true
    f U(500, 800), k1 U(-0.1, 0.05), k2 U(-0.01, 0.01); the start turned
    by 0.01 rad, moved by 0.05, f off by 2 %, k1 = k2 = 0, points moved
    by 0.05. Returns (``read_bal``'s fields, true cameras)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n_points, 3))
    a = np.linspace(-0.6, 0.6, n_cams)
    C = np.stack([8 * np.sin(a), rng.normal(0, 0.3, n_cams),
                  8 * np.cos(a)], 1)
    d = -C / np.linalg.norm(C, axis=1, keepdims=True)
    right = np.cross(d, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    R = np.stack([right, np.cross(-d, right), -d], 1)
    cams = np.zeros((n_cams, 9))
    cams[:, :3] = SC.rotvec(R)
    cams[:, 3:6] = -np.einsum("nij,nj->ni", R, C)
    cams[:, 6] = rng.uniform(500, 800, n_cams)
    cams[:, 7] = rng.uniform(-0.1, 0.05, n_cams)
    cams[:, 8] = rng.uniform(-0.01, 0.01, n_cams)
    obs_cam = np.tile(np.arange(n_cams), n_points)
    obs_pt = np.repeat(np.arange(n_points), n_cams)
    uv, pz = SC.project(cams[obs_cam], X[obs_pt])
    assert (pz < 0).all()
    uv += rng.normal(0, noise, uv.shape)
    start = cams.copy()
    start[:, :3] = SC.rotvec(SC.rotmat(rng.normal(0, 0.01, (n_cams, 3)))
                             @ SC.rotmat(cams[:, :3]))
    start[:, 3:6] += rng.normal(0, 0.05, (n_cams, 3))
    start[:, 6] *= 1 + rng.normal(0, 0.02, n_cams)
    start[:, 7:] = 0.0
    return dict(cams=start, points=X + rng.normal(0, 0.05, X.shape),
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv), cams


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _reference(fields, dtype=torch.float64):
    return REF.bundle_adjust(_t(fields["cams"]), _t(fields["points"]),
                             _t(fields["obs_cam"]), _t(fields["obs_pt"]),
                             _t(fields["obs_uv"]), dtype=dtype)


def _reproj_gap(cams, points, rc, rp, p):
    return float((REF.reprojections(cams, points, p.obs_cam, p.obs_pt)
                  - REF.reprojections(rc, rp, p.obs_cam, p.obs_pt)
                  ).norm(dim=1).max())


@pytest.fixture(scope="module")
def problems():
    out = []
    for seed in (3, 11):
        fields, _ = arc_problem(seed)
        out.append((fields, _reference(fields)))
    return out


def test_reference_jacobian_matches_central_differences():
    fields, _ = arc_problem(5, n_points=40)
    cams = _t(fields["cams"][fields["obs_cam"]])
    X = _t(fields["points"][fields["obs_pt"]])
    cams[:, 7], cams[:, 8] = 0.05, -0.01
    cams[:7, :3] = 0.0                     # the small-angle branch
    _, Jc, Jp = REF.project(cams, X, jacobians=True)
    eps = 1e-6
    for J, x, other in ((Jc, cams, X), (Jp, X, cams)):
        num = []
        for e in torch.eye(x.shape[1], dtype=torch.float64) * eps:
            if x is cams:
                num.append(REF.project(x + e, other) - REF.project(x - e,
                                                                  other))
            else:
                num.append(REF.project(other, x + e)
                           - REF.project(other, x - e))
        num = torch.stack(num, 2) / (2 * eps)
        assert float((num - J).abs().max()) <= 1e-7 * float(J.abs().max())


def test_program_projection_is_bal_and_its_jacobian_the_reference():
    fields, _ = arc_problem(7, n_points=30)
    fields["cams"][:, 7], fields["cams"][:, 8] = 0.03, -0.004
    p = BAL.problem_from_bal(fields, device="cpu")
    p64 = p._replace(cams=p.cams.double(), points=p.points.double(),
                     obs_uv=p.obs_uv.double())
    uv, Jc, Jp = REF.project(p64.cams[p.obs_cam], p64.points[p.obs_pt],
                             jacobians=True)
    r = B.residuals(p64)
    assert torch.allclose(r, uv - p64.obs_uv, rtol=0, atol=1e-9)
    jc, jp = B._jacobians(p64)
    assert torch.allclose(jc, Jc, rtol=1e-9, atol=1e-9 * float(
        Jc.abs().max()))
    assert torch.allclose(jp, Jp, rtol=1e-9, atol=1e-9 * float(
        Jp.abs().max()))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "cg"])
def test_bundle_adjust_f64_takes_the_reference_steps(problems, dense):
    for fields, (rc, rp, rcost) in problems:
        p = BAL.problem_from_bal(fields, device="cpu")
        p = p._replace(cams=_t(fields["cams"]), points=_t(fields["points"]),
                       obs_uv=_t(fields["obs_uv"]))
        out, costs = B.bundle_adjust(p, iters=10, dense=dense, cg_iters=60)
        tol = 1e-8 if dense else 1e-5
        assert torch.allclose(costs, rcost, rtol=tol, atol=0), (costs,
                                                                rcost)
        assert _reproj_gap(out.cams, out.points, rc, rp, p) <= 1e-6


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "cg"])
def test_bundle_adjust_f32_reaches_the_reference(problems, dense):
    for fields, (rc, rp, rcost) in problems:
        p = BAL.problem_from_bal(fields, device="cpu")
        assert p.cams.dtype == torch.float32 and not p.cam_fixed.any()
        out, costs = B.bundle_adjust(p, iters=10, dense=dense)
        assert costs.shape == (10,) and bool((costs[1:] <= costs[:-1]).all())
        assert torch.allclose(costs.double(), rcost, rtol=5e-3, atol=0), (
            costs, rcost)
        assert _reproj_gap(out.cams, out.points, rc, rp, p) <= 5e-3
        c0 = float(REF._cost(_t(fields["cams"]), _t(fields["points"]),
                             p.obs_cam, p.obs_pt, _t(fields["obs_uv"])))
        assert float(costs[-1]) < 0.01 * c0


def test_bfloat16_reference_is_far_off(problems):
    """The control of the benchmark's check: the reference in bfloat16
    misses the float64 one by pixels, not millipixels."""
    fields, (rc, rp, _) = problems[0]
    bc, bp, _ = _reference(fields, torch.bfloat16)
    p = BAL.problem_from_bal(fields, device="cpu")
    assert _reproj_gap(bc, bp, rc, rp, p) > 0.5


def test_read_write_round_trip(tmp_path):
    fields, _ = arc_problem(2, n_cams=3, n_points=7)
    for name in ("p.txt", "p.txt.bz2"):
        path = str(tmp_path / name)
        BAL.write_bal(path, fields)
        back = BAL.read_bal(path)
        assert set(back) == set(fields)
        for k, v in fields.items():
            assert np.array_equal(back[k], np.asarray(v)), k
    with open(tmp_path / "p.txt") as fh:
        assert fh.readline().split() == ["3", "7", "21"]
    text = (tmp_path / "p.txt").read_text().split("\n")
    (tmp_path / "short.txt").write_text("\n".join(text[:-3]))
    with pytest.raises(ValueError):
        BAL.read_bal(str(tmp_path / "short.txt"))
    p = BAL.problem_from_bal(BAL.read_bal(path), device="cpu")
    assert p.cams.shape == (3, 9) and p.cams.dtype == torch.float32
    assert p.obs_cam.dtype == torch.int64 and bool(p.obs_valid.all())
    assert not bool(p.cam_fixed.any())


def test_opt_intr_raises_on_bal_cameras():
    fields, _ = arc_problem(2, n_cams=3, n_points=10)
    p = BAL.problem_from_bal(fields, device="cpu")
    lam = p.cams.new_full((), 1e-3)
    with pytest.raises(ValueError):
        B.bundle_adjust(p, iters=1, opt_intr=True)
    with pytest.raises(ValueError):
        B.schur_dense_step(p, lam, opt_intr=True)
    with pytest.raises(ValueError):
        B.intr_step(p, lam)
    with pytest.raises(ValueError):
        B.bundle_adjust(p._replace(cams=p.cams[:, :7]), iters=1)


def test_dense_schur_feasible_takes_the_width():
    # Dubrovnik-88: 64,298 x 88 blocks of 9 x 3 f32 = 611 MB
    assert B.dense_schur_feasible(88, 64298, width=9)
    assert 64298 * 88 * 108 == 611_088_192
    assert B.dense_schur_feasible(455, 1000, width=9)
    assert not B.dense_schur_feasible(456, 1000, width=9)
    n = (1 << 31) // (100 * 108)
    assert B.dense_schur_feasible(100, n, width=9)
    assert not B.dense_schur_feasible(100, n + 1, width=9)
    # the 6-wide default as before: 72 bytes a block, 682 cameras
    assert B.dense_schur_feasible(100, 40000)
    assert B.dense_schur_feasible(682, 100) \
        and not B.dense_schur_feasible(683, 100)
    m = (1 << 31) // (100 * 72)
    assert B.dense_schur_feasible(100, m) \
        and not B.dense_schur_feasible(100, m + 1)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "cg"])
def test_spans_and_counters_of_a_traced_call(dense):
    fields, _ = arc_problem(4, n_cams=4, n_points=20)
    p = BAL.problem_from_bal(fields, device="cpu")
    No, Nc, Np = len(fields["obs_cam"]), 4, 20
    profiling.reset()
    profiling.enable_tracing(True)
    try:
        B.bundle_adjust(p, iters=2, dense=dense, cg_iters=5)
    finally:
        profiling.enable_tracing(False)
    spans = profiling.spans()
    names = [s["name"] for s in spans]
    top = [s for s in spans if s["name"] == "ba"]
    assert len(top) == 1 and top[0]["parent"] is None
    for stage in ("ba.linearize", "ba.reduce", "ba.solve", "ba.trial"):
        inner = [s for s in spans if s["name"] == stage]
        assert len(inner) == 2, names
        assert all(s["parent"] == top[0]["id"] for s in inner)
        assert all(top[0]["start_ns"] <= s["start_ns"] <= s["end_ns"]
                   <= top[0]["end_ns"] for s in inner)
    c = profiling.counters()
    assert c["ba.calls"] == 1 and c["ba.iters"] == 2 and c["ba.obs"] == 2 * No
    if dense:
        assert c["ba.coupling_blocks"] == 2 * Np * Nc
        assert c["ba.coupling_obs"] == 2 * No and "ba.cg_iters" not in c
    else:
        assert c["ba.cg_iters"] == 10 and "ba.coupling_blocks" not in c
    profiling.reset()
    B.bundle_adjust(p, iters=1, dense=dense)     # tracing off: nothing
    assert profiling.counters() == {} and profiling.spans() == []


def test_bal_scene_has_the_counts_asked_for():
    fields, truth = SC.bal_scene(2 ** 31 + 11, n_cams=88, n_points=1500,
                                 n_obs=9000)
    assert fields["cams"].shape == (88, 9)
    assert fields["points"].shape == (1500, 3)
    assert len(fields["obs_cam"]) == len(fields["obs_pt"]) == 9000
    L = np.bincount(fields["obs_pt"], minlength=1500)
    assert L.min() >= 2 and L.sum() == 9000
    assert np.bincount(fields["obs_cam"], minlength=88).min() > 0
    pairs = fields["obs_pt"] * 88 + fields["obs_cam"]
    assert len(np.unique(pairs)) == len(pairs)
    uv, pz = SC.project(truth["cams"][fields["obs_cam"]],
                        truth["points"][fields["obs_pt"]])
    assert (pz <= -SC.DEPTH[0]).all()
    assert (np.abs(uv) <= [SC.HALF_W, SC.HALF_H]).all()
    assert np.abs(uv - fields["obs_uv"]).max() < 8 * SC.NOISE_PX
    assert (fields["cams"][:, 7:] == 0).all()
    again, _ = SC.bal_scene(2 ** 31 + 11, n_cams=88, n_points=1500,
                            n_obs=9000)
    assert all(np.array_equal(again[k], fields[k]) for k in fields)


def test_reference_imports_only_torch():
    path = inspect.getsourcefile(REF)
    with open(path) as fh:
        tree = ast.parse(fh.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "contextlib", "torch"}, mods
