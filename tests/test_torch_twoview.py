"""popsift_tpu_torch.sfm (rotation, twoview) against the JAX package on
the CPU, on the same numpy inputs made from seeds, plus ports of the
JAX package's own two-view tests (tests/test_sfm.py:44-112,
tests/test_cv2_sfm_parity.py:33-108).

RANSAC draws cannot match: JAX draws its sample ranks with threefry. The
parity tests compute JAX's ranks as twoview.py:121 does and give them to
the port (``ranks=``). Tolerances: exp_so3/log_so3 within 1e-6; the
minimal solvers on the same well-conditioned sample sets within 1e-4
after scale and sign are normalised; residuals within 1e-5 relative;
RANSAC: the same chosen hypothesis unless two MSAC scores lie within
1e-6 relative, inlier masks equal except points whose error lies within
1e-4 relative of the gate; poses and triangulated points within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.sfm import rotation as JR
from popsift_tpu.sfm import twoview as JT
from popsift_tpu_torch.sfm import rotation as TR
from popsift_tpu_torch.sfm import twoview as TT

torch.set_num_threads(1)


def _t(*arrays):
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    return out if len(out) > 1 else out[0]


def _unit(M, ref):
    """M scaled to unit norm with the sign that agrees with ``ref``, per
    matrix of a [..., 3, 3] batch."""
    M = np.asarray(M, np.float64).reshape(-1, 9)
    ref = np.asarray(ref, np.float64).reshape(-1, 9)
    M = M / np.linalg.norm(M, axis=1, keepdims=True)
    return M * np.where(np.sum(M * ref, 1, keepdims=True) < 0, -1.0, 1.0)


def _assert_models_close(port, jax_models, tol=1e-4):
    jm = _unit(jax_models, jax_models)
    np.testing.assert_allclose(_unit(port, jm), jm, atol=tol)


def _scene(rng, n_pts=100, noise=0.0):
    """Points in front of two cameras on a small baseline
    (tests/test_sfm.py:24-41); returns X, cams, normalized observations."""
    X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n_pts, 3))
    cams = []
    for i in range(2):
        w = np.array([0.02 * i, 0.03 * i, 0.01 * i])
        R = TR.exp_so3(_t(w.astype(np.float32))).numpy().astype(np.float64)
        C = np.array([0.5 * i, 0.05 * i, -0.1 * i])
        cams.append((R, -R @ C))
    obs = []
    for R, t in cams:
        Xc = X @ R.T + t
        x = Xc[:, :2] / Xc[:, 2:3]
        if noise > 0:
            x = x + rng.normal(0, noise, x.shape)
        obs.append(x.astype(np.float32))
    return X.astype(np.float32), cams, obs


def _outlier_scene(seed, n=100, n_out=20, noise=0.0, n_invalid=5):
    rng = np.random.default_rng(seed)
    X, cams, (x1, x2) = _scene(rng, n, noise)
    x2 = x2.copy()
    x2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return X, cams, x1, x2, valid


def _homography_scene(seed, n=80, n_out=15, scale=400.0):
    rng = np.random.default_rng(seed)
    H = np.array([[1.1, 0.02, 5.0], [-0.03, 0.95, -3.0],
                  [1e-4, -2e-5, 1.0]])
    x1 = rng.uniform(0, scale, (n, 2))
    h = np.concatenate([x1, np.ones((n, 1))], 1) @ H.T
    x2 = h[:, :2] / h[:, 2:3]
    x2[:n_out] = rng.uniform(0, scale, (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32), H


def _jax_ranks(key, valid, n_hyp, m):
    """JAX's sample ranks, drawn as twoview.py:121 draws them."""
    return np.asarray(jax.random.randint(key, (n_hyp, m), 0, jnp.maximum(
        jnp.sum(jnp.asarray(valid).astype(jnp.int32)), 1)))


# ---------------------------------------------------------------------------
# rotation
# ---------------------------------------------------------------------------

def test_rotation_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 3)).astype(np.float32) * 0.8
    w[0] = 0.0
    w[1] = [3e-7, -2e-7, 1e-7]                 # the first-order branch
    R = np.asarray(JR.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(TR.exp_so3(_t(w)).numpy(), R, atol=1e-6)
    np.testing.assert_allclose(TR.log_so3(_t(R)).numpy(),
                               np.asarray(JR.log_so3(jnp.asarray(R))),
                               atol=1e-6)
    np.testing.assert_array_equal(TR.hat(_t(w)).numpy(),
                                  np.asarray(JR.hat(jnp.asarray(w))))


def test_rotation_roundtrip():
    """Port of tests/test_sfm.py:44-53."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 3)).astype(np.float32) * 0.8
    R = TR.exp_so3(_t(w))
    np.testing.assert_allclose(TR.log_so3(R).numpy(), w, atol=1e-4)
    RtR = torch.einsum("nij,nik->njk", R, R).numpy()
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# solvers and residuals
# ---------------------------------------------------------------------------

def _rot(axis, deg):
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def _wide_pair(rng, n, noise=0.0):
    """Normalized observations of points in a wide field of view from two
    cameras 15 degrees and a unit baseline apart."""
    X = rng.uniform([-3, -3, 2], [3, 3, 5], size=(n, 3))
    Xc = X @ _rot([0.3, 1.0, 0.2], 15.0).T + np.array([1.0, 0.2, 0.3])
    x1, x2 = X[:, :2] / X[:, 2:3], Xc[:, :2] / Xc[:, 2:3]
    return [(x + rng.normal(0, noise, x.shape)).astype(np.float32)
            if noise else x.astype(np.float32) for x in (x1, x2)]


def _well_conditioned(A, n_keep):
    """Indices of the first ``n_keep`` systems A [S, m, 9] whose
    sigma_1 / sigma_8 is below 1000 in f64: a backward-stable f32 solver
    finds their null vector within about 0.3 x 1000 x 6e-8 = 2e-5."""
    s = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    keep = np.nonzero(s[:, 0] / s[:, 7] < 1000)[0]
    assert len(keep) >= n_keep
    return keep[:n_keep]


def _eight_point_rows(x1, x2):
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    return np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     np.ones_like(u1)], -1)


def _dlt_rows(x1, x2):
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    z, o = np.zeros_like(u1), np.ones_like(u1)
    return np.concatenate([
        np.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], -1),
        np.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)], -2)


def test_minimal_solvers_match_jax():
    """On the same well-conditioned sample sets (distinct rows)."""
    rng = np.random.default_rng(1)
    x1, x2 = _wide_pair(rng, 200, noise=1e-3)
    idx = np.stack([rng.permutation(200)[:8] for _ in range(128)])
    idx = idx[_well_conditioned(_eight_point_rows(x1[idx], x2[idx]), 32)]
    e1, e2 = x1[idx], x2[idx]
    F_j = np.asarray(JT.eight_point(jnp.asarray(e1), jnp.asarray(e2)))
    _assert_models_close(TT.eight_point(*_t(e1, e2)).numpy(), F_j)
    E_j = np.asarray(JT.essential_project(jnp.asarray(F_j)))
    _assert_models_close(TT.essential_project(_t(F_j)).numpy(), E_j)
    y1 = rng.uniform(-1, 1, (200, 2))
    h = np.concatenate([y1, np.ones((200, 1))], 1) @ np.array(
        [[1.05, 0.1, 0.2], [-0.05, 0.9, -0.1], [0.05, -0.02, 1.0]]).T
    y2 = h[:, :2] / h[:, 2:3] + rng.normal(0, 1e-3, (200, 2))
    idx = np.stack([rng.permutation(200)[:4] for _ in range(128)])
    idx = idx[_well_conditioned(_dlt_rows(y1[idx], y2[idx]), 32)]
    h1, h2 = y1[idx].astype(np.float32), y2[idx].astype(np.float32)
    H_j = np.asarray(JT.homography_dlt(jnp.asarray(h1), jnp.asarray(h2)))
    _assert_models_close(TT.homography_dlt(*_t(h1, h2)).numpy(), H_j)


def test_normalize_points_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 500, (50, 2)).astype(np.float32)
    valid = rng.random(50) < 0.8
    pj, Tj = JT._normalize_points(jnp.asarray(pts), jnp.asarray(valid))
    pt, Tt = TT._normalize_points(*_t(pts, valid))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-5)


def test_residuals_match_jax():
    """Residuals of 16 random models at 100 random point pairs within
    1e-5 relative; a residual that cancels to near zero by chance is
    held to 1e-5 of the mean residual instead."""
    rng = np.random.default_rng(4)
    M = rng.normal(size=(16, 3, 3)).astype(np.float32)
    x1 = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
    for jf, tf in ((JT.sampson_error, TT.sampson_error),
                   (JT.homography_error, TT.homography_error)):
        want = np.asarray(jf(jnp.asarray(M), jnp.asarray(x1),
                             jnp.asarray(x2)))
        np.testing.assert_allclose(tf(*_t(M, x1, x2)).numpy(), want,
                                   rtol=1e-5, atol=1e-5 * want.mean())


# ---------------------------------------------------------------------------
# RANSAC from JAX's ranks
# ---------------------------------------------------------------------------


def _scores(pkg, solver, err_fn, x1, x2, valid, ranks, thresh):
    """MSAC score of every hypothesis of ``ranks``, by one package's
    own functions (twoview.py:124-131)."""
    rows = np.nonzero(valid)[0][ranks]
    arr = (lambda a: jnp.asarray(a)) if pkg is JT else _t
    models = solver(pkg, arr(x1[rows]), arr(x2[rows]))
    err = np.asarray(err_fn(pkg)(models, arr(x1), arr(x2)))[:, valid]
    return np.sum(np.minimum(err, thresh), 1)


def _check_ransac(got, want, scores_p, scores_j, err_fn, x1, x2, valid,
                  thresh):
    """The port's result against JAX's: the same chosen hypothesis, or
    two whose MSAC scores lie within 1e-6 relative; the inlier masks
    equal except within 1e-4 relative of the gate; the model within
    1e-4 after normalisation where the pick is the same, the score
    within 1e-4 relative."""
    pick_p, pick_j = int(np.argmin(scores_p)), int(np.argmin(scores_j))
    if pick_p != pick_j:
        for s in (scores_p, scores_j):
            assert abs(s[pick_p] - s[pick_j]) <= 1e-6 * abs(s[pick_j])
    else:
        _assert_models_close(got.model.numpy()[None],
                             np.asarray(want.model)[None])
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=1e-4)
    err = np.asarray(err_fn(JT)(jnp.asarray(want.model)[None],
                                jnp.asarray(x1), jnp.asarray(x2)))[0]
    near = np.abs(err - thresh) <= 1e-4 * thresh
    differ = got.inliers.numpy() != np.asarray(want.inliers)
    assert not (differ & ~near).any()


def _homography_points(seed, n=80, n_out=15):
    """Normalized-scale correspondences of a homography with 1e-3 noise
    and outliers."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (n, 2))
    h = np.concatenate([x1, np.ones((n, 1))], 1) @ np.array(
        [[1.05, 0.1, 0.2], [-0.05, 0.9, -0.1], [0.05, -0.02, 1.0]]).T
    x2 = h[:, :2] / h[:, 2:3] + rng.normal(0, 1e-3, (n, 2))
    x2[:n_out] = rng.uniform(-1, 1, (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32)


def test_ransac_homography_from_jax_ranks():
    x1, x2 = _homography_points(3)
    valid = np.ones(80, bool)
    valid[-4:] = False
    thresh = 1e-5
    key = jax.random.PRNGKey(1)
    ranks = _jax_ranks(key, valid, 256, 4)
    want = JT.ransac_homography(key, jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(valid), thresh=thresh,
                                n_hyp=256)
    got = TT.ransac_homography(None, *_t(x1, x2, valid), thresh=thresh,
                               ranks=_t(ranks))
    scores = [_scores(pkg, lambda m, a, b: m.homography_dlt(a, b),
                      lambda m: m.homography_error, x1, x2, valid, ranks,
                      thresh) for pkg in (TT, JT)]
    _check_ransac(got, want, *scores, lambda m: m.homography_error, x1, x2,
                  valid, thresh)
    assert int(got.n_inliers) == int(want.n_inliers) >= 55


@pytest.mark.parametrize("thresh", [1e-5, 1e-4])
def test_ransac_essential_from_jax_ranks(thresh):
    """Gates well above the inliers' squared Sampson errors (3e-4 noise):
    a point at the gate could flip the refit's keep-or-drop, which the
    mask rule allows but the model check would not."""
    rng = np.random.default_rng(1)
    x1, x2 = _wide_pair(rng, 100, noise=3e-4)
    x2[:20] = rng.uniform(-1, 1, (20, 2))
    valid = np.ones(100, bool)
    valid[-5:] = False
    key = jax.random.PRNGKey(0)
    ranks = _jax_ranks(key, valid, 256, 8)
    want = JT.ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2),
                               jnp.asarray(valid), thresh=thresh, n_hyp=256)
    got = TT.ransac_essential(None, *_t(x1, x2, valid), thresh=thresh,
                              ranks=_t(ranks))
    scores = [_scores(pkg, lambda m, a, b: m.essential_project(
        m.eight_point(a, b)), lambda m: m.sampson_error, x1, x2, valid,
        ranks, thresh) for pkg in (TT, JT)]
    _check_ransac(got, want, *scores, lambda m: m.sampson_error, x1, x2,
                  valid, thresh)


def test_draw_ranks_cover_the_valid_rows():
    valid = torch.zeros(2, 50, dtype=torch.bool)
    valid[0, :7] = True
    valid[1, 10:40] = True
    gen = torch.Generator().manual_seed(5)
    r = TT.draw_ranks(gen, valid, 4000, 8)
    assert r.shape == (2, 4000, 8) and r.dtype == torch.int64
    assert set(r[0].unique().tolist()) == set(range(7))
    assert set(r[1].unique().tolist()) == set(range(30))
    again = TT.draw_ranks(torch.Generator().manual_seed(5), valid, 4000, 8)
    assert torch.equal(r, again)
    assert (TT.draw_ranks(gen, torch.zeros(9, dtype=torch.bool), 3, 4)
            == 0).all()


# ---------------------------------------------------------------------------
# pose, refinement, triangulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pose_case():
    """JAX's essential RANSAC, pose and refined pose on a noisy scene with
    outliers, and the inputs."""
    _, cams, x1, x2, valid = _outlier_scene(2, noise=1e-3)
    key = jax.random.PRNGKey(2)
    args = [jnp.asarray(a) for a in (x1, x2, valid)]
    res = JT.ransac_essential(key, *args, thresh=2e-5)
    R, t, good = JT.recover_pose(res.model, args[0], args[1], res.inliers)
    R2, t2 = JT.refine_pose(R, t, args[0], args[1], res.inliers)
    return dict(x1=x1, x2=x2, valid=valid, E=np.asarray(res.model),
                inl=np.asarray(res.inliers), R=np.asarray(R),
                t=np.asarray(t), good=np.asarray(good), R2=np.asarray(R2),
                t2=np.asarray(t2))


def test_recover_pose_matches_jax(pose_case):
    c = pose_case
    R, t, good = TT.recover_pose(*_t(c["E"], c["x1"], c["x2"], c["inl"]))
    np.testing.assert_allclose(R.numpy(), c["R"], atol=1e-4)
    np.testing.assert_allclose(t.numpy(), c["t"], atol=1e-4)
    np.testing.assert_array_equal(good.numpy(), c["good"])


def test_refine_pose_matches_jax(pose_case):
    c = pose_case
    R, t = TT.refine_pose(*_t(c["R"], c["t"], c["x1"], c["x2"], c["inl"]))
    np.testing.assert_allclose(R.numpy(), c["R2"], atol=1e-4)
    np.testing.assert_allclose(t.numpy(), c["t2"], atol=1e-4)
    assert abs(float(torch.linalg.norm(t)) - 1.0) < 1e-5


def test_triangulate_matches_jax():
    rng = np.random.default_rng(2)
    X, cams, (x1, x2) = _scene(rng, 50, noise=1e-3)
    (R1, t1), (R2, t2) = [(R.astype(np.float32), t.astype(np.float32))
                          for R, t in cams]
    want = np.asarray(JT.triangulate(*[jnp.asarray(a) for a in
                                       (R1, t1, R2, t2, x1, x2)]))
    got = TT.triangulate(*_t(R1, t1, R2, t2, x1, x2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    # per-row poses: every row against its own pair of cameras
    n = len(x1)
    Rs = np.stack([R1, R2] * (n // 2)).reshape(n, 3, 3)
    ts = np.stack([t1, t2] * (n // 2)).reshape(n, 3)
    rows = [np.flip(Rs, 0).copy(), np.flip(ts, 0).copy()]
    args = (Rs, ts, rows[0], rows[1], x1, x2)
    want = np.asarray(JT.triangulate_rows(*[jnp.asarray(a) for a in args]))
    got = TT.triangulate_rows(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_solve_pairs_batch_from_jax_ranks():
    """Three edges, each from its own key (jax.random.split, twoview.py
    :357) and so its own ranks."""
    B, n, n_hyp = 3, 90, 128
    x1s, x2s, vs = [], [], []
    for b in range(B):
        _, _, x1, x2, valid = _outlier_scene(10 + b, n=n, n_out=10,
                                             noise=1e-4, n_invalid=3 + b)
        x1s.append(x1)
        x2s.append(x2)
        vs.append(valid)
    x1s, x2s, vs = np.stack(x1s), np.stack(x2s), np.stack(vs)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, B)
    ranks = np.stack([_jax_ranks(keys[b], vs[b], n_hyp, 8)
                      for b in range(B)])
    want = [np.asarray(a) for a in JT.solve_pairs_batch(
        key, jnp.asarray(x1s), jnp.asarray(x2s), jnp.asarray(vs),
        thresh=1e-6, n_hyp=n_hyp)]
    got = [a.numpy() for a in TT.solve_pairs_batch(
        None, *_t(x1s, x2s, vs), thresh=1e-6, ranks=_t(ranks))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)      # R
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)      # t
    np.testing.assert_array_equal(got[2], want[2])              # good
    good = want[2]
    assert good.sum() >= B * 60
    # triangulated points of the good rows, relative to their depth
    err = np.abs(got[3] - want[3]).max(-1) / np.linalg.norm(want[3], axis=-1)
    assert err[good].max() < 1e-4


# ---------------------------------------------------------------------------
# ports of the JAX package's own two-view tests
# ---------------------------------------------------------------------------

def test_essential_ransac_and_pose():
    """Port of tests/test_sfm.py:56-84."""
    rng = np.random.default_rng(1)
    X, cams, (x1, x2) = _scene(rng, 100)
    x2c = x2.copy()
    x2c[:20] = rng.uniform(-0.5, 0.5, (20, 2)).astype(np.float32)
    valid = torch.ones(100, dtype=torch.bool)
    res = TT.ransac_essential(torch.Generator().manual_seed(0),
                              *_t(x1, x2c), valid, thresh=1e-6, n_hyp=256)
    inl = res.inliers.numpy()
    assert inl[20:].sum() >= 70 and inl[:20].sum() <= 3
    R2, t2, _ = TT.recover_pose(res.model, *_t(x1, x2c), res.inliers)
    R_gt, t_gt = cams[1]
    t_gt_n = t_gt / np.linalg.norm(t_gt)
    t_est = t2.numpy()
    assert min(np.linalg.norm(t_est - t_gt_n),
               np.linalg.norm(t_est + t_gt_n)) < 0.02
    dR = R2.numpy() @ R_gt.T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.01


def test_triangulation_exact():
    """Port of tests/test_sfm.py:87-95."""
    rng = np.random.default_rng(2)
    X, cams, obs = _scene(rng, 50)
    (R1, t1), (R2, t2) = cams
    Xe = TT.triangulate(*_t(*(a.astype(np.float32) for a in
                              (R1, t1, R2, t2))), *_t(*obs)).numpy()
    np.testing.assert_allclose(Xe, X, atol=2e-2)


def test_homography_ransac():
    """Port of tests/test_sfm.py:98-112."""
    x1, x2, _ = _homography_scene(3)
    res = TT.ransac_homography(torch.Generator().manual_seed(1),
                               *_t(x1, x2), torch.ones(80, dtype=torch.bool),
                               thresh=1.0, n_hyp=256)
    inl = res.inliers.numpy()
    assert inl[15:].sum() >= 60 and inl[:15].sum() <= 2


def test_homography_parity_with_cv2():
    """Port of tests/test_cv2_sfm_parity.py:33-61."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    H_gt = np.array([[1.05, 0.02, 8.0], [-0.03, 0.98, -5.0],
                     [1e-4, -5e-5, 1.0]])
    n = 200
    x1 = rng.uniform(0, 500, size=(n, 2))
    p = np.concatenate([x1, np.ones((n, 1))], axis=1) @ H_gt.T
    x2 = p[:, :2] / p[:, 2:3] + rng.normal(0, 0.4, (n, 2))
    x2[:40] = rng.uniform(0, 500, size=(40, 2))
    res = TT.ransac_homography(torch.Generator().manual_seed(0),
                               *_t(x1.astype(np.float32),
                                   x2.astype(np.float32)),
                               torch.ones(n, dtype=torch.bool))
    H_cv, mask_cv = cv2.findHomography(x1, x2, cv2.RANSAC, 2.0)

    def h_err(H):
        q = np.concatenate([x1[40:], np.ones((n - 40, 1))], 1) @ (
            H / H[2, 2]).T
        return np.sqrt(((q[:, :2] / q[:, 2:3] - x2[40:]) ** 2).sum(1)).mean()

    e_ours, e_cv = h_err(res.model.numpy().astype(np.float64)), h_err(H_cv)
    assert e_ours < 1.0 and e_cv < 1.0 and e_ours < e_cv + 0.5
    assert (res.inliers.numpy() == mask_cv.ravel().astype(bool)).mean() \
        >= 0.9


def test_essential_pose_parity_with_cv2():
    """Port of tests/test_cv2_sfm_parity.py:64-107."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    n = 300
    X = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n, 3))
    R_gt = _rot([0.2, 1.0, 0.1], 9.0)
    t_gt = np.array([0.8, 0.05, 0.1])
    t_gt /= np.linalg.norm(t_gt)
    x1 = X[:, :2] / X[:, 2:3]
    Xc = X @ R_gt.T + t_gt
    x2 = Xc[:, :2] / Xc[:, 2:3]
    x1 += rng.normal(0, 1e-3, x1.shape)
    x2 += rng.normal(0, 1e-3, x2.shape)
    x2[:30] = rng.uniform(-0.5, 0.5, (30, 2))
    a, b = _t(x1.astype(np.float32), x2.astype(np.float32))
    res = TT.ransac_essential(torch.Generator().manual_seed(2), a, b,
                              torch.ones(n, dtype=torch.bool), thresh=2e-5)
    R_o, t_o, _ = TT.recover_pose(res.model, a, b, res.inliers)
    R_o, t_o = TT.refine_pose(R_o, t_o, a, b, res.inliers)
    E_cv, _ = cv2.findEssentialMat(x1, x2, np.eye(3), cv2.RANSAC, 0.999,
                                   1e-3)
    _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, x1, x2, np.eye(3))

    def rot_err(R):
        c = (np.trace(R_gt @ np.asarray(R, np.float64).T) - 1) / 2
        return np.rad2deg(np.arccos(np.clip(c, -1, 1)))

    def t_err(t):
        t = np.asarray(t, np.float64).ravel()
        return np.rad2deg(np.arccos(np.clip(
            abs(t @ t_gt) / np.linalg.norm(t), -1, 1)))

    assert rot_err(R_o.numpy()) < 1.0 and t_err(t_o.numpy()) < 2.0
    assert rot_err(R_cv) < 1.0 and t_err(t_cv) < 2.0
    assert rot_err(R_o.numpy()) < rot_err(R_cv) + 1.0
    assert t_err(t_o.numpy()) < t_err(t_cv) + 1.0
