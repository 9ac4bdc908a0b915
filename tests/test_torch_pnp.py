"""popsift_tpu_torch.sfm.pnp against popsift_tpu.sfm.pnp on the CPU, on
the same numpy inputs made from seeds, plus ports of the JAX package's
PnP tests (tests/test_sfm_incremental.py:75-90,
tests/test_cv2_sfm_parity.py:110-141) run through both packages.

The DLT's null vector has no fixed sign, and the two packages' SVDs
return opposite signs for some systems (pnp.py's docstring). Where P's
rotation block has det < 0, the polar step picks its flipped axis from
three equal singular values, so any two SVDs give different rotations
(a quirk of the reference kept for parity). So the null vector is
compared up to sign, the pose only where both packages' P carry the same
sign and det > 0, and the post-processing alone on JAX's own P where its
det > 0. RANSAC takes JAX's sample ranks
(``jax.random.randint`` as pnp.py:85 and :142 draw them); its result is
compared, not the index of the winning hypothesis.

Tolerances: null vectors within 1e-4 up to sign on systems with
sigma_1 / sigma_11 < 1000; poses within 1e-4; the post-processing of
JAX's P within 1e-6 in t and 2e-6 in R (the two packages' f32 SVDs of
the rotation block differ by up to 1.25e-6 in R over six seeds, ROADMAP
C); squared reprojection errors within 1e-6 with inf at
the same entries; RANSAC's refined R and t within 1e-4 and its inlier
masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.sfm import pnp as JP
from popsift_tpu_torch.sfm import pnp as TP
from test_sfm_incremental import INTR, make_multiview

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_P(X, x):
    """JAX's DLT null vector, computed by pnp.py:25-34 as written."""
    X, x = jnp.asarray(X), jnp.asarray(x)
    ones = jnp.ones(X.shape[:2], X.dtype)
    zeros4 = jnp.zeros(X.shape[:2] + (4,), X.dtype)
    Xh = jnp.concatenate([X, ones[..., None]], axis=-1)
    u, v = x[..., 0], x[..., 1]
    r1 = jnp.concatenate([Xh, zeros4, -u[..., None] * Xh], axis=-1)
    r2 = jnp.concatenate([zeros4, Xh, -v[..., None] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=1)
    return np.asarray(jnp.linalg.svd(A)[2][:, -1, :]), np.asarray(A)


def _pose_scene(seed, n=96, n_out=24, noise=0.0):
    """Camera 1 of tests/test_sfm_incremental.py::make_multiview seeing
    ``n`` points, the first ``n_out`` observations replaced by uniform
    outliers (as :75-84 make them)."""
    rng = np.random.default_rng(seed)
    X, cams, kps = make_multiview(rng, n_pts=n, n_cams=2)
    fx, fy, cx, cy = INTR
    uv = kps[1]
    x = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    if noise:
        x = x + rng.normal(0, noise, x.shape)
    x[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return X, x.astype(np.float32), cams[1]


def _samples(seed, S=64):
    """S 6-point inlier samples of a pose scene whose DLT system has
    sigma_1 / sigma_11 < 1000 in f64."""
    X, x, _ = _pose_scene(seed, n_out=0)
    rng = np.random.default_rng(seed + 100)
    idx = np.stack([rng.choice(len(X), 6, replace=False)
                    for _ in range(4 * S)])
    _, A = _jax_P(X[idx], x[idx])
    s = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    keep = idx[s[:, 0] / s[:, 10] < 1000][:S]
    assert len(keep) == S
    return X[keep], x[keep]


def _det_positive(P):
    return np.linalg.det(P.reshape(-1, 3, 4)[:, :, :3].astype(np.float64)) > 0


def _jax_ranks(key, valid, n_hyp=256):
    return np.asarray(jax.random.randint(key, (n_hyp, 6), 0, max(
        int(np.sum(valid)), 1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_dlt_null_vector_matches_jax_up_to_sign(seed):
    X, x = _samples(seed)
    Pj, _ = _jax_P(X, x)
    Pt = TP.dlt_projection(_t(X), _t(x)).numpy()
    sign = np.sign(np.sum(Pt * Pj, 1, keepdims=True))
    np.testing.assert_allclose(Pt * sign, Pj, atol=1e-4)
    # the pose where both solvers chose the same sign, and det > 0
    Rj, tj = map(np.asarray, JP.pnp_dlt(jnp.asarray(X), jnp.asarray(x)))
    Rt, tt = (a.numpy() for a in TP.pnp_dlt(_t(X), _t(x)))
    same = (sign[:, 0] > 0) & _det_positive(Pj)
    assert same.sum() >= 8
    np.testing.assert_allclose(Rt[same], Rj[same], atol=1e-4)
    np.testing.assert_allclose(tt[same], tj[same], atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_from_jax_projection_matches_jax(seed):
    """The port's post-processing (pnp.py:36-56) of JAX's own P, on every
    sample whose rotation block has det > 0, whichever sign JAX's SVD
    gave it."""
    X, x = _samples(seed)
    Pj, _ = _jax_P(X, x)
    Rj, tj = map(np.asarray, JP.pnp_dlt(jnp.asarray(X), jnp.asarray(x)))
    Rt, tt = TP.pose_from_projection(_t(Pj), _t(X))
    good = _det_positive(Pj)
    assert 8 <= good.sum() < len(good)
    np.testing.assert_allclose(Rt.numpy()[good], Rj[good], rtol=0, atol=2e-6)
    np.testing.assert_allclose(tt.numpy()[good], tj[good], rtol=0, atol=1e-6)


def test_reprojection_error2_matches_jax():
    rng = np.random.default_rng(3)
    X, x, _ = _pose_scene(3, n_out=10)
    X = X.copy()
    X[-6:, 2] = -X[-6:, 2]                        # behind the camera
    R = np.stack([np.eye(3), *TP.pnp_dlt(*map(_t, _samples(3, S=3)))[0]
                  .numpy()]).astype(np.float32)
    t = rng.normal(0, 0.1, (4, 3)).astype(np.float32)
    want = np.asarray(JP.reprojection_error2(*map(jnp.asarray, (R, t, X, x))))
    got = TP.reprojection_error2(*map(_t, (R, t, X, x))).numpy()
    assert np.isinf(want).any()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def _assert_same_result(got, want):
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert np.array_equal(got.n_inliers.numpy(), np.asarray(want.n_inliers))


@pytest.mark.parametrize("seed,thresh,noise,n_invalid", [
    (0, 1e-5, 0.0, 0), (1, 1e-4, 1e-3, 7), (2, 2e-4, 1e-3, 20)])
def test_ransac_pnp_matches_jax_from_its_ranks(seed, thresh, noise,
                                               n_invalid):
    X, x, _ = _pose_scene(seed, noise=noise)
    valid = np.ones(len(X), bool)
    valid[len(X) - n_invalid:] = False
    key = jax.random.PRNGKey(seed)
    want = JP.ransac_pnp(key, jnp.asarray(X), jnp.asarray(x),
                         jnp.asarray(valid), thresh=thresh)
    got = TP.ransac_pnp(None, _t(X), _t(x), _t(valid), thresh=thresh,
                        ranks=_t(_jax_ranks(key, valid)))
    _assert_same_result(got, want)


def test_ransac_pnp_batch_matches_jax_from_its_ranks():
    scenes = [_pose_scene(s, noise=1e-3) for s in (4, 5, 6)]
    X = np.stack([s[0] for s in scenes])
    x = np.stack([s[1] for s in scenes])
    valid = np.ones(X.shape[:2], bool)
    valid[1, 70:] = False
    valid[2, :5] = False
    key = jax.random.PRNGKey(9)
    want = JP.ransac_pnp_batch(key, jnp.asarray(X), jnp.asarray(x),
                               jnp.asarray(valid), thresh=2e-4)
    ranks = np.stack([_jax_ranks(k, v) for k, v in
                      zip(jax.random.split(key, len(X)), valid)])
    got = TP.ransac_pnp_batch(None, _t(X), _t(x), _t(valid), thresh=2e-4,
                              ranks=_t(ranks))
    _assert_same_result(got, want)
    # each row is the single-image call with its ranks
    for b in range(len(X)):
        one = TP.ransac_pnp(None, _t(X[b]), _t(x[b]), _t(valid[b]),
                            thresh=2e-4, ranks=_t(ranks[b]))
        for f in got._fields:
            a, c = getattr(got, f)[b], getattr(one, f)
            assert torch.allclose(a.to(torch.float64), c.to(torch.float64),
                                  rtol=0, atol=1e-6), f


def test_ransac_pnp_draws_from_a_generator():
    X, x, (R, t) = _pose_scene(7, noise=1e-3)
    valid = np.ones(len(X), bool)
    gen = torch.Generator().manual_seed(0)
    res = TP.ransac_pnp_batch(gen, _t(X[None]), _t(x[None]), _t(valid[None]),
                              thresh=2e-4)
    assert int(res.n_inliers[0]) >= 96 - 24 - 2
    np.testing.assert_allclose(res.R[0].numpy(), R, atol=1e-2)


def test_pnp_ransac_with_outliers():
    """Port of tests/test_sfm_incremental.py:75-90, through both
    packages from the same ranks."""
    X, x, (R, t) = _pose_scene(3)
    n_out = 24
    valid = np.ones(len(X), bool)
    key = jax.random.PRNGKey(0)
    want = JP.ransac_pnp(key, jnp.asarray(X), jnp.asarray(x),
                         jnp.asarray(valid), thresh=1e-5)
    res = TP.ransac_pnp(None, _t(X), _t(x), _t(valid), thresh=1e-5,
                        ranks=_t(_jax_ranks(key, valid)))
    for r in (res, want):
        assert int(r.n_inliers) >= 96 - n_out - 2
        np.testing.assert_allclose(np.asarray(r.R), R, atol=1e-3)
        np.testing.assert_allclose(np.asarray(r.t), t, atol=1e-2)
    _assert_same_result(res, want)


def test_pnp_parity_with_cv2():
    """Port of tests/test_cv2_sfm_parity.py:110-141, both packages from
    the same ranks, each held to cv2's accuracy bar."""
    cv2 = pytest.importorskip("cv2")
    from test_cv2_sfm_parity import _rot

    rng = np.random.default_rng(3)
    n = 150
    X = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    R_gt = _rot([0.1, 0.3, 1.0], 14.0)
    t_gt = np.array([0.4, -0.2, 0.6])
    Xc = X @ R_gt.T + t_gt
    x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (n, 2))
    x[:15] = rng.uniform(-0.5, 0.5, (15, 2))        # 10% outliers
    X32, x32 = X.astype(np.float32), x.astype(np.float32)
    valid = np.ones(n, bool)

    key = jax.random.PRNGKey(4)
    want = JP.ransac_pnp(key, jnp.asarray(X), jnp.asarray(x),
                         jnp.ones(n, bool))
    res = TP.ransac_pnp(None, _t(X32), _t(x32), _t(valid),
                        ranks=_t(_jax_ranks(key, valid)))
    ok, rvec, tvec, _ = cv2.solvePnPRansac(
        X.astype(np.float64), x.astype(np.float64), np.eye(3), None,
        flags=cv2.SOLVEPNP_ITERATIVE, reprojectionError=3e-3)
    assert ok
    R_cv = cv2.Rodrigues(rvec)[0]

    def pose_err(R, t):
        c = (np.trace(R_gt @ np.asarray(R).T) - 1) / 2
        rot = np.rad2deg(np.arccos(np.clip(c, -1, 1)))
        return rot, np.linalg.norm(np.asarray(t).ravel() - t_gt)

    r_c, t_c = pose_err(R_cv, tvec)
    assert r_c < 0.5 and t_c < 0.05
    for r in (res, want):
        r_o, t_o = pose_err(r.R, r.t)
        assert r_o < 0.5 and t_o < 0.05, (r_o, t_o)
        assert r_o < r_c + 0.5 and t_o < t_c + 0.05
    _assert_same_result(res, want)
