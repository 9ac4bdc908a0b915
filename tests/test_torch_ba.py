"""popsift_tpu_torch.sfm.ba and .evaluate against popsift_tpu.sfm on the
CPU, on the same problems (tests/test_sfm.py::_make_ba_problem, built
for both packages from the same numpy arrays through
``problem_from_numpy``), plus ports of tests/test_sfm.py's four
``test_bundle_adjustment_*`` and ``test_umeyama_alignment`` run through
both packages.

Tolerances, and why the f32 steps are held in two ways:
- residuals within 1e-6 x the row's max |observed pixel| (a residual is
  the difference of two f32 numbers near 300 px, so its rounding is that
  of the pixel); Jacobians within 1e-5 x the row's max; costs within
  1e-6 relative.
- The f32 steps of JAX's problems (camera 0 fixed) are not a function
  of the inputs at f32 precision: the scale gauge is free (S's smallest
  eigenvalue is lam), and last-bit differences of the Jacobians move
  the steps by up to 0.47 x their max; with the scale fixed too
  (cameras 0 and 1) by up to 6.7e-4, and 6.1e-3 with the intrinsics
  solved jointly (ROADMAP C). So the steps are held in f64, where the
  same code of both packages computes them: the port's dense step (with
  and without ``opt_intr``) to the exact damped Gauss-Newton step solved
  densely with numpy from JAX's f64 Jacobians, its CG step and
  ``intr_step`` to JAX's, each within 1e-4 x the step's max. (JAX's own
  dense step in f64 rounds B to f32, ``preferred_element_type``, and is
  5e-2 off that step.) In f32, on the scale-fixed problems: ``intr_step``
  within 1e-4 x its max, the dense and CG steps within 1e-3, the joint
  step within 1e-2.
- ``bundle_adjust`` in f64: each iteration's cost within 1e-4 relative,
  the same accept/reject pattern wherever the cost moves by more than
  1e-9 relative (below that the last bits decide), cameras within 1e-4;
  the dense path against JAX's CG path solved to convergence
  (cg_iters=60), for the reason above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.sfm import ba as JB
from popsift_tpu.sfm import evaluate as JE
from popsift_tpu.sfm.rotation import exp_so3 as j_exp_so3
from popsift_tpu_torch.sfm import ba as TB
from popsift_tpu_torch.sfm import evaluate as TE
from test_sfm import _make_ba_problem, _rotmat

torch.set_num_threads(1)
LAM = 1e-3
MASK = (1.0, 1.0, 0.0, 0.0)
FLOATS = ("cams", "points", "intr", "obs_uv")
# (seed, noise px) of tests/test_sfm.py's with_noise and converges tests
PROBLEMS = {"noise": (5, 0.5), "exact": (4, 0.0)}
# JAX's functions compiled whole, as its bundle_adjust runs them (and one
# compile costs less than the eager per-op ones)
J_RES = jax.jit(JB.residuals)
J_JAC = jax.jit(JB._jacobians)
J_IJAC = jax.jit(JB._intr_jacobian)
J_DENSE = jax.jit(JB.schur_dense_step,
                  static_argnames=("huber_delta", "opt_intr", "intr_mask"))
J_CG = jax.jit(JB.schur_cg_step, static_argnames=("huber_delta",))
J_INTR = jax.jit(JB.intr_step, static_argnames=("huber_delta", "intr_mask"))


def _fields(jp):
    return {k: np.asarray(v) for k, v in jp._asdict().items()}


def _problem(name, fix_scale=False):
    """JAX's problem as numpy fields; ``fix_scale`` fixes camera 1 too."""
    seed, noise = PROBLEMS[name]
    jp, cams_gt, _ = _make_ba_problem(np.random.default_rng(seed),
                                      noise_px=noise)
    f = _fields(jp)
    if fix_scale:
        f["cam_fixed"] = f["cam_fixed"].copy()
        f["cam_fixed"][1] = True
    return f, cams_gt


def _jax(f):
    """JAX's BAProblem of the fields, f64 where x64 is enabled."""
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return JB.BAProblem(**{k: jnp.asarray(v, dt) if k in FLOATS
                           else jnp.asarray(v) for k, v in f.items()})


def _port(f, dtype=torch.float32):
    p = TB.problem_from_numpy(f, device="cpu")
    return p._replace(**{k: getattr(p, k).to(dtype) for k in FLOATS})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _lm_step(jp, lam, huber_delta=None, mask=None):
    """The damped Gauss-Newton step (J^T J + lam I) x = -J^T r over every
    camera, point (and the masked intrinsics), solved densely with numpy
    from JAX's Jacobians, IRLS-weighted as ba.py weights them."""
    Nc, Np = jp.cams.shape[0], jp.points.shape[0]
    r = np.asarray(J_RES(jp))
    Jc, Jp = map(np.asarray, J_JAC(jp))
    Ji = np.asarray(J_IJAC(jp))
    if huber_delta is not None:
        sw = np.asarray(JB._huber_sw(jnp.asarray(r), huber_delta))
        r, Jc, Jp, Ji = r * sw, Jc * sw[..., None], Jp * sw[..., None], \
            Ji * sw[..., None]
    oc, op = np.asarray(jp.obs_cam), np.asarray(jp.obs_pt)
    ni = 0 if mask is None else 4
    n = 6 * Nc + 3 * Np + ni
    J = np.zeros((2 * len(oc), n))
    for o, (c, q) in enumerate(zip(oc, op)):
        J[2 * o:2 * o + 2, 6 * c:6 * c + 6] = Jc[o]
        J[2 * o:2 * o + 2, 6 * Nc + 3 * q:6 * Nc + 3 * q + 3] = Jp[o]
        if mask is not None:
            J[2 * o:2 * o + 2, n - 4:] = Ji[o] * np.asarray(mask)
    H = J.T @ J + lam * np.eye(n)
    if mask is not None:
        H[n - 4:, n - 4:] += np.diag(1.0 - np.asarray(mask))
    x = np.linalg.solve(H, -J.T @ r.reshape(-1))
    out = [x[:6 * Nc].reshape(Nc, 6), x[6 * Nc:6 * Nc + 3 * Np].reshape(Np, 3)]
    return out if mask is None else out + [x[n - 4:] * np.asarray(mask)]


def _port_step(kind, p, lam, hd, reduce=None):
    if kind == "dense":
        return TB.schur_dense_step(p, lam, reduce=reduce, huber_delta=hd)
    if kind == "dense_intr":
        return TB.schur_dense_step(p, lam, reduce=reduce, huber_delta=hd,
                                   opt_intr=True, intr_mask=MASK)
    return TB.schur_cg_step(p, lam, reduce=reduce, huber_delta=hd)


def _jax_step(kind, p, lam, hd):
    if kind == "dense":
        return J_DENSE(p, lam, huber_delta=hd)
    if kind == "dense_intr":
        return J_DENSE(p, lam, huber_delta=hd, opt_intr=True, intr_mask=MASK)
    return J_CG(p, lam, huber_delta=hd)


# ---------------------------------------------------------------------------
# residuals and Jacobians
# ---------------------------------------------------------------------------

def _assert_rows_close(got, want, scale, tol):
    err = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(want), -1)
    rowmax = np.abs(np.asarray(scale)).reshape(len(want), -1).max(1)
    assert np.all(err.max(1) <= tol * rowmax), float(
        (err.max(1) / rowmax).max())


@pytest.mark.parametrize("name", PROBLEMS)
def test_residuals_and_jacobians_match_jax(name):
    f, _ = _problem(name)
    jp, tp = _jax(f), _port(f)
    _assert_rows_close(TB.residuals(tp), J_RES(jp), f["obs_uv"], 1e-6)
    for got, want in zip(TB._jacobians(tp), J_JAC(jp)):
        _assert_rows_close(got, want, want, 1e-5)
    want = np.asarray(J_IJAC(jp))
    _assert_rows_close(TB._intr_jacobian(tp), want, want, 1e-5)
    r = TB.residuals(tp)
    for hd in (None, 1.0):
        assert _rel(TB.robust_cost(r, hd),
                    JB.robust_cost(J_RES(jp), hd)) < 1e-6


def test_problem_from_numpy_types():
    f, _ = _problem("noise")
    p = TB.problem_from_numpy(f, device="cpu")
    assert p.obs_cam.dtype == p.obs_pt.dtype == torch.int64
    assert p.cams.dtype == p.obs_uv.dtype == torch.float32
    assert p.obs_valid.dtype == p.cam_fixed.dtype == torch.bool
    for k, v in f.items():
        assert np.array_equal(getattr(p, k).numpy(), v), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TB.problem_from_numpy(f)


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

HDS = {"l2": None, "huber": 1.0}


@pytest.fixture(scope="module")
def f64():
    """JAX's f64 results on the noise problem (its focal 3 % off for the
    intrinsics steps), computed once: the damped GN steps from its
    Jacobians, its CG and intrinsics steps, and its LM loop (CG path,
    25 and 60 CG iterations)."""
    f, _ = _problem("noise")
    fi = dict(f, intr=f["intr"] * np.float32(1.03))
    out = {"f": f, "fi": fi}
    with jax.enable_x64(True):
        jp, jpi = _jax(f), _jax(fi)
        lam = jnp.float64(LAM)
        for h, hd in HDS.items():
            out["dense", h] = _lm_step(jp, LAM, hd)
            out["dense_intr", h] = _lm_step(jp, LAM, hd, MASK)
            out["cg", h] = [np.asarray(a) for a in
                            J_CG(jp, lam, huber_delta=hd)]
            out["intr", h] = np.asarray(J_INTR(jpi, lam, huber_delta=hd,
                                               intr_mask=MASK))
            out["cost", h] = np.asarray(JB.robust_cost(J_RES(jp), hd))
        for cg_iters in (25, 60):
            o, c = JB.bundle_adjust(jp, iters=8, dense=False,
                                    cg_iters=cg_iters)
            out["ba", cg_iters] = np.asarray(c), np.asarray(o.cams)
    return out


@pytest.mark.parametrize("h", HDS)
@pytest.mark.parametrize("kind", ["dense", "dense_intr", "cg"])
def test_step_is_the_damped_gn_step_in_f64(f64, kind, h):
    tp = _port(f64["f"], torch.float64)
    got = _port_step(kind, tp, torch.tensor(LAM, dtype=torch.float64),
                     HDS[h])
    for a, b in zip(got[:-1], f64[kind if kind != "cg" else "dense", h]):
        assert _rel(a, b) < 1e-4
    assert _rel(got[-1], f64["cost", h]) < 1e-6
    if kind == "cg":
        for a, b in zip(got, f64["cg", h]):
            assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("h", HDS)
def test_intr_step_matches_jax_in_f64(f64, h):
    tp = _port(f64["fi"], torch.float64)
    got = TB.intr_step(tp, torch.tensor(LAM, dtype=torch.float64),
                       huber_delta=HDS[h], intr_mask=MASK)
    assert _rel(got, f64["intr", h]) < 1e-4
    assert got[2] == got[3] == 0


@pytest.mark.parametrize("hd", [None, 1.0], ids=["l2", "huber"])
@pytest.mark.parametrize("kind", ["dense", "dense_intr", "cg", "intr"])
@pytest.mark.parametrize("name", PROBLEMS)
def test_step_matches_jax_in_f32(name, kind, hd):
    f, _ = _problem(name, fix_scale=True)
    tp, jp = _port(f), _jax(f)
    lam = torch.tensor(LAM)
    if kind == "intr":
        got = [TB.intr_step(tp, lam, huber_delta=hd, intr_mask=MASK)]
        want = [J_INTR(jp, jnp.float32(LAM), huber_delta=hd,
                       intr_mask=MASK)]
    else:
        got = _port_step(kind, tp, lam, hd)
        want = _jax_step(kind, jp, jnp.float32(LAM), hd)
        assert _rel(got[-1], want[-1]) < 1e-6
        got, want = got[:-1], want[:-1]
    tol = {"intr": 1e-4, "dense_intr": 1e-2}.get(kind, 1e-3)
    for a, b in zip(got, want):
        assert _rel(a, b) < tol


@pytest.mark.parametrize("kind", ["dense", "dense_intr", "cg", "intr"])
def test_reduce_identity_is_bit_equal(kind):
    f, _ = _problem("noise")
    tp, lam = _port(f), torch.tensor(LAM)
    if kind == "intr":
        pairs = [(TB.intr_step(tp, lam, huber_delta=1.0),
                  TB.intr_step(tp, lam, huber_delta=1.0,
                               reduce=lambda x: x))]
    else:
        pairs = zip(_port_step(kind, tp, lam, 1.0),
                    _port_step(kind, tp, lam, 1.0, reduce=lambda x: x))
    for a, b in pairs:
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the LM loop
# ---------------------------------------------------------------------------

def _accepts(cost0, costs):
    """Accepted steps and how far each moved the cost (relative): a step
    is accepted exactly when the cost it returns is below the last."""
    c = np.concatenate([[cost0], np.asarray(costs, np.float64)])
    return c[1:] < c[:-1], np.abs(np.diff(c)) / c[:-1]


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "cg"])
def test_bundle_adjust_matches_jax_in_f64(f64, dense):
    tp = _port(f64["f"], torch.float64)
    out, costs = TB.bundle_adjust(tp, iters=8, dense=dense)
    cost0 = float(TB.robust_cost(TB.residuals(tp)))
    jcosts, jcams = f64["ba", 60 if dense else 25]
    np.testing.assert_allclose(costs.numpy(), jcosts, rtol=1e-4)
    ok, moved = _accepts(cost0, costs.numpy())
    jok, jmoved = _accepts(cost0, jcosts)
    decisive = (moved > 1e-9) | (jmoved > 1e-9)
    assert decisive[:3].all() and ok[:3].all()
    assert np.array_equal(ok[decisive], jok[decisive])
    assert _rel(out.cams, jcams) < 1e-4


# ---------------------------------------------------------------------------
# ports of tests/test_sfm.py
# ---------------------------------------------------------------------------

def _ate(cams, cams_gt, mod):
    return mod.ate_rmse(mod.camera_centers(np.asarray(cams)),
                        mod.camera_centers(cams_gt))


def test_bundle_adjustment_converges():
    """Port of tests/test_sfm.py:225-237, through both packages."""
    f, cams_gt = _problem("exact")
    for mod, E, p in ((TB, TE, _port(f)), (JB, JE, _jax(f))):
        cost0 = float((np.asarray(mod.residuals(p)) ** 2).sum())
        out, costs = mod.bundle_adjust(p, iters=12, cg_iters=30)
        cost1 = float((np.asarray(mod.residuals(out)) ** 2).sum())
        assert cost1 < cost0 * 1e-4, f"BA did not converge: {cost0} -> {cost1}"
        assert _ate(out.cams, cams_gt, E) < 1e-3


def test_bundle_adjustment_with_noise():
    """Port of tests/test_sfm.py:240-246, through both packages; their
    final costs within 1e-4 relative."""
    f, cams_gt = _problem("noise")
    finals = []
    for mod, E, p in ((TB, TE, _port(f)), (JB, JE, _jax(f))):
        out, costs = mod.bundle_adjust(p, iters=10, cg_iters=25)
        assert _ate(out.cams, cams_gt, E) < 5e-3
        finals.append(float(np.asarray(costs)[-1]))
    assert abs(finals[0] - finals[1]) < 1e-4 * finals[1]


def test_umeyama_alignment():
    """Port of tests/test_sfm.py:249-258; the copy equals the original."""
    rng = np.random.default_rng(6)
    src = rng.standard_normal((30, 3))
    R = _rotmat(rng, 0.5)
    s, t = 1.7, np.array([1.0, -2.0, 0.5])
    dst = s * src @ R.T + t
    s2, R2, t2 = TE.umeyama(src, dst)
    assert abs(s2 - s) < 1e-6
    np.testing.assert_allclose(R2, R, atol=1e-6)
    assert TE.ate_rmse(src, dst) < 1e-6
    for a, b in zip((s2, R2, t2), JE.umeyama(src, dst)):
        assert np.array_equal(a, b)
    noisy = dst + rng.normal(0, 0.1, dst.shape)
    assert TE.ate_rmse(src, noisy) == JE.ate_rmse(src, noisy)
    assert TE.ate_rmse(src, noisy, False) == JE.ate_rmse(src, noisy, False)


def test_camera_centers_match_jax():
    rng = np.random.default_rng(8)
    cams = rng.normal(0, 0.5, (12, 6))
    cams[0, :3] = 0.0
    for c in (cams, cams.astype(np.float32)):
        np.testing.assert_allclose(TE.camera_centers(c), JE.camera_centers(c),
                                   rtol=0, atol=1e-6)


def test_bundle_adjustment_huber_outliers():
    """Port of tests/test_sfm.py:261-289, through both packages."""
    rng = np.random.default_rng(7)
    jp, cams_gt, _ = _make_ba_problem(rng, noise_px=0.3)
    f = _fields(jp)
    uv = f["obs_uv"].copy()
    n_obs = uv.shape[0]
    bad = rng.choice(n_obs, size=n_obs // 20, replace=False)
    uv[bad] += rng.normal(0, 80.0, (len(bad), 2))
    f["obs_uv"] = uv.astype(np.float32)
    for mod, E, p in ((TB, TE, _port(f)), (JB, JE, _jax(f))):
        out_l2, _ = mod.bundle_adjust(p, iters=12)
        ate_l2 = _ate(out_l2.cams, cams_gt, E)
        for dense in (True, False):
            out_h, costs = mod.bundle_adjust(p, iters=12, dense=dense,
                                             huber_delta=1.0)
            ate_h = _ate(out_h.cams, cams_gt, E)
            assert costs[-1] <= costs[0]
            assert ate_h < 6e-3, f"robust ATE {ate_h} (dense={dense})"
            assert ate_h < ate_l2 / 10, (ate_h, ate_l2)


def _focal_scene():
    """tests/test_sfm.py:163-209's scene: 8 tilted cameras round 80
    points, the shared focal 5 % off."""
    rng = np.random.default_rng(11)
    f, cx, cy = 500.0, 320.0, 240.0
    n_cams, n_pts = 8, 80
    X = rng.uniform([-2, -2, -2], [2, 2, 2],
                    size=(n_pts, 3)).astype(np.float32)
    cams_gt = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams * 0.35
        C = np.array([8 * np.sin(ang), 3.0 * np.sin(2 * ang + 1.0),
                      -8 * np.cos(ang)], np.float32)
        w = np.array([0.25 * np.sin(3.1 * i + 0.5), ang,
                      0.1 * np.cos(2.3 * i)], np.float32)
        R = np.asarray(j_exp_so3(jnp.asarray(w)))
        cams_gt.append(np.concatenate([w, (-R @ C).astype(np.float32)]))
    cams_gt = np.stack(cams_gt)
    obs_cam, obs_pt, obs_uv = [], [], []
    for ci in range(n_cams):
        R = np.asarray(j_exp_so3(jnp.asarray(cams_gt[ci, :3])))
        Xc = X @ R.T + cams_gt[ci, 3:]
        uv = np.stack([f * Xc[:, 0] / Xc[:, 2] + cx,
                       f * Xc[:, 1] / Xc[:, 2] + cy], 1)
        uv += rng.normal(0, 0.2, uv.shape)
        for pi in range(n_pts):
            obs_cam.append(ci)
            obs_pt.append(pi)
            obs_uv.append(uv[pi])
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(cams=cams0, points=X0,
                intr=np.array([f * 1.05, f * 1.05, cx, cy], np.float32),
                obs_cam=np.asarray(obs_cam, np.int32),
                obs_pt=np.asarray(obs_pt, np.int32),
                obs_uv=np.asarray(obs_uv, np.float32),
                obs_valid=np.ones(len(obs_cam), bool), cam_fixed=fixed), f


def test_bundle_adjustment_recovers_perturbed_focal():
    """Port of tests/test_sfm.py:163-222, through both packages; the two
    focals within 1e-4 relative of each other."""
    fields, f = _focal_scene()
    focals = []
    for mod, p in ((TB, _port(fields)), (JB, _jax(fields))):
        out, costs = mod.bundle_adjust(p, iters=20, opt_intr=True,
                                       intr_mask=MASK)
        intr = np.asarray(out.intr)
        for f_est in intr[:2]:
            assert abs(f_est - f) / f < 0.005, f"focal {f_est} vs true {f}"
        np.testing.assert_allclose(intr[2:], fields["intr"][2:], rtol=0,
                                   atol=0)
        out2, _ = mod.bundle_adjust(p, iters=20)
        np.testing.assert_allclose(float(out2.intr[0]), f * 1.05)
        focals.append(intr[:2])
    np.testing.assert_allclose(focals[0], focals[1], rtol=1e-4)
