"""popsift_tpu_torch.sfm.global_sfm against popsift_tpu.sfm.global_sfm on
the CPU, plus ports of the JAX package's global-SfM tests
(tests/test_global_sfm.py) run through the port.

The averaging solvers take the inputs of JAX's four solver tests and an
asymmetric graph (edges in both orientations, repeated, some masked by
``valid``). Their f32 systems pin the gauge with a 1e6 diagonal plus
1e-6 I (global_sfm.py:84-85, :143-145 of the JAX package), and that
conditioning, not the port, sets how closely two f32 solvers agree:
JAX's own translation solves sit 1.0e-4 to 7.7e-4 x the result's scale
from the exact (f64) solve of the same IRLS, and the port is held to
JAX within twice JAX's own gap or 1e-4 x the scale, whichever is larger
(ROADMAP C; the measured gaps are printed); their IRLS costs within
1e-2 relative (measured 3.7e-3). Rotations agree within 1e-5 (measured
2.4e-7); their costs within 2e-3 relative (measured 7.6e-4: a
near-identity misfit's angle comes from arccos of the f32 trace). In
f64 each solve is held to ``numpy.linalg.solve`` of the same system,
built here from the JAX code's [n, 3, n, 3] indexing, within 1e-9 x the
solution's scale. CG iterates short of convergence are
rounding-dominated in f32 (the 1e6 pin enters every inner product): on
the 12,000-node problem at 80 iterations the two packages end 0.57 x
the scale apart at the worst node, each as far from its f64 run, so
there the port is held to the JAX test's gate. ``global_sfm`` itself is
held to JAX in tests/test_torch_global_sfm_e2e.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from popsift_tpu.sfm import global_sfm as JG
from popsift_tpu_torch.sfm import global_sfm as TG
from popsift_tpu_torch.sfm.evaluate import umeyama
from test_global_sfm import _graph, _rand_rot

torch.set_num_threads(1)


def _t(*arrays):
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# the solver tests' inputs (tests/test_global_sfm.py)
# ---------------------------------------------------------------------------

def rotation_problem(scale=1.0):
    """:33-44: 30 random rotations, a chain + random edges, 0.5 deg noise
    and 10 % gross outlier edges (``scale`` sets the rotations' spread)."""
    rng = np.random.default_rng(0)
    n = 30
    R_gt = np.stack([_rand_rot(rng, scale) for _ in range(n)])
    ei, ej = _graph(rng, n)
    E = len(ei)
    R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei])  # R_j R_i^T
    noise = np.stack([_rand_rot(rng, 0.005) for _ in range(E)])
    R_rel = np.einsum("eab,ebc->eac", noise, R_rel)
    bad = rng.choice(E, E // 10, replace=False)
    R_rel[bad] = np.stack([_rand_rot(rng, scale) for _ in bad])
    return n, ei, ej, R_rel.astype(np.float32), R_gt


def translation_problem(seed=1, n=30, noise=0.005, outliers=True):
    """:57-68 (seed 1, outliers) and :91-98 (seed 5, n 24, no outliers)."""
    rng = np.random.default_rng(seed)
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ei, ej = _graph(rng, n)
    E = len(ei)
    d = C_gt[ej] - C_gt[ei]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(0, noise, d.shape)
    if outliers:
        bad = rng.choice(E, E // 10, replace=False)
        d[bad] = rng.normal(0, 1, (len(bad), 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return n, ei, ej, d.astype(np.float32), C_gt


def large_problem():
    """:117-130: 12,000 nodes, a ring + 3n random chords, exact directions."""
    rng = np.random.default_rng(9)
    n = 12000
    C_gt = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ei = np.arange(n, dtype=np.int32)
    ej = np.roll(ei, -1)
    ch_i = rng.integers(0, n, 3 * n).astype(np.int32)
    ch_j = rng.integers(0, n, 3 * n).astype(np.int32)
    keep = ch_i != ch_j
    ei = np.concatenate([ei, ch_i[keep]])
    ej = np.concatenate([ej, ch_j[keep]])
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
         ).astype(np.float32)
    return n, ei, ej, d, C_gt


def asymmetric_problem(kind: str):
    """Edges in both orientations (some repeated), node degrees uneven,
    a fifth of the edges masked out by ``valid``."""
    rng = np.random.default_rng(4)
    n = 16
    ei = list(range(n - 1))
    ej = list(range(1, n))
    for _ in range(3 * n):
        i, j = rng.integers(0, n, 2)
        if i != j and rng.random() < 0.7 * (1 + (i < 4)):
            ei.append(i)
            ej.append(j)
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)
    valid = rng.random(len(ei)) > 0.2
    valid[:n - 1] = True                       # keep the chain
    if kind == "rotation":
        R_gt = np.stack([_rand_rot(rng, 0.3) for _ in range(n)])
        R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei])
        noise = np.stack([_rand_rot(rng, 0.01) for _ in range(len(ei))])
        R_rel = np.einsum("eab,ebc->eac", noise, R_rel)
        R_rel[~valid] = np.stack([_rand_rot(rng) for _ in range(
            int((~valid).sum()))])              # garbage the mask hides
        return n, ei, ej, R_rel.astype(np.float32), valid
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = C_gt[ej] - C_gt[ei]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(0, 0.005, d.shape)
    d[~valid] = rng.normal(0, 1, (int((~valid).sum()), 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return n, ei, ej, d.astype(np.float32), valid


def _scale(C):
    return float(np.linalg.norm(C - C.mean(0), axis=1).mean())


def _worst(a, b, scale):
    return float(np.linalg.norm(a - b, axis=1).max()) / scale


# ---------------------------------------------------------------------------
# the solvers against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["noise_and_outliers", "asymmetric"])
def test_rotation_averaging_matches_jax(problem):
    if problem == "asymmetric":
        n, ei, ej, R_rel, valid = asymmetric_problem("rotation")
    else:
        n, ei, ej, R_rel, _ = rotation_problem()
        valid = None
    jv = None if valid is None else jnp.asarray(valid)
    Rj, cj = JG.rotation_averaging(n, jnp.asarray(ei), jnp.asarray(ej),
                                   jnp.asarray(R_rel), valid=jv)
    Rt, ct = TG.rotation_averaging(n, *_t(ei, ej, R_rel),
                                   valid=None if valid is None else _t(valid))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    # the costs sum w |v|^2, and |v| of a near-identity misfit comes from
    # arccos of the f32 trace (log_so3), a few 1e-3 relative at 0.3 deg
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2e-3)


TRANSLATION_CASES = {
    "dense_noise_and_outliers": ("dense", dict(seed=1), {}),
    "dense_cg_problem": ("dense", dict(seed=5, n=24, noise=0.003,
                                       outliers=False), {}),
    "cg_cg_problem": ("cg", dict(seed=5, n=24, noise=0.003, outliers=False),
                      dict(cg_iters=400)),
    "dense_asymmetric": ("dense", None, {}),
    "cg_asymmetric": ("cg", None, dict(cg_iters=400)),
}


@pytest.mark.parametrize("case", list(TRANSLATION_CASES))
def test_translation_averaging_matches_jax(case):
    """The port within twice JAX's own f32 gap to the exact solve of the
    same IRLS (the port in f64) or 1e-4 x the scale, whichever is
    larger."""
    kind, args, kw = TRANSLATION_CASES[case]
    if args is None:
        n, ei, ej, d, valid = asymmetric_problem("translation")
    else:
        n, ei, ej, d, _ = translation_problem(**args)
        valid = None
    jfn = {"dense": JG.translation_averaging,
           "cg": JG.translation_averaging_cg}[kind]
    tfn = {"dense": TG.translation_averaging,
           "cg": TG.translation_averaging_cg}[kind]
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    Cj, cj = jfn(n, jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(d),
                 valid=jv, **kw)
    Cj = np.asarray(Cj)
    Ct, ct = tfn(n, *_t(ei, ej, d), valid=tv, **kw)
    C64, _ = tfn(n, *_t(ei, ej, d.astype(np.float64)), valid=tv, **kw)
    scale = _scale(C64.numpy())
    floor = _worst(Cj, C64.numpy(), scale)
    gap = _worst(Ct.numpy(), Cj, scale)
    print(f"{case}: port against JAX {gap:.3g} x the scale, JAX against "
          f"the f64 solve {floor:.3g}")
    assert gap <= max(1e-4, 2 * floor), (gap, floor)
    # the costs sum w ang^2 over edges whose angular residual is a few
    # 1e-3: the centers' f32 floor moves them by up to 4e-3 relative
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-2)


# ---------------------------------------------------------------------------
# f64: each solve is the exact solve of the JAX code's system
# ---------------------------------------------------------------------------

def _numpy_translation_system(n, ei, ej, d, w):
    """H [3n, 3n] and rhs of global_sfm.py:122-145 (JAX package), in
    numpy f64, with the [n, 3, n, 3] layout of ``H.at[ii, :, ii, :]``."""
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    Pw = (np.eye(3)[None] - np.einsum("ea,eb->eab", d, d)) * w[:, None, None]
    H = np.zeros((n, 3, n, 3))
    for e, (i, j) in enumerate(zip(ei, ej)):
        H[i, :, i, :] += Pw[e]
        H[j, :, j, :] += Pw[e]
        H[i, :, j, :] -= Pw[e]
        H[j, :, i, :] -= Pw[e]
    H = H.reshape(3 * n, 3 * n)
    s = np.zeros((n, 3))
    np.add.at(s, ej, w[:, None] * d)
    np.add.at(s, ei, -w[:, None] * d)
    s = s.reshape(-1)
    H = H + np.outer(s, s)
    H[np.arange(3), np.arange(3)] += 1e6
    H = H + 1e-6 * np.eye(3 * n)
    return H, w.sum() * s


@pytest.mark.parametrize("kind", ["dense", "cg"])
@pytest.mark.parametrize("problem", ["cg_problem", "asymmetric"])
def test_translation_solve_f64_is_exact(kind, problem):
    """iters=0: the solve of the unit-weight system, against numpy."""
    if problem == "asymmetric":
        n, ei, ej, d, valid = asymmetric_problem("translation")
    else:
        n, ei, ej, d, _ = translation_problem(5, 24, 0.003, False)
        valid = np.ones(len(ei), bool)
    d = d.astype(np.float64)
    H, rhs = _numpy_translation_system(n, ei, ej, d, valid.astype(np.float64))
    want = np.linalg.solve(H, rhs).reshape(n, 3)
    if kind == "dense":
        got, costs = TG.translation_averaging(n, *_t(ei, ej, d), iters=0,
                                              valid=_t(valid))
    else:
        got, costs = TG.translation_averaging_cg(
            n, *_t(ei, ej, d), iters=0, cg_iters=1500, valid=_t(valid))
    assert got.dtype == torch.float64 and costs.shape == (0,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-9 * _scale(want))


@pytest.mark.parametrize("problem", ["moderate", "asymmetric"])
def test_rotation_solve_f64_is_exact(problem):
    """iters=1 from R = I: one Laplacian solve of the JAX code's system
    (global_sfm.py:61-93), v from scipy's log map, against numpy."""
    from scipy.spatial.transform import Rotation

    if problem == "asymmetric":
        n, ei, ej, R_rel, valid = asymmetric_problem("rotation")
    else:
        n, ei, ej, R_rel, _ = rotation_problem(scale=0.3)
        valid = np.ones(len(ei), bool)
    # orthonormal in f64, so both log maps see the same rotations
    R_rel = Rotation.from_matrix(R_rel.astype(np.float64)).as_matrix()
    v = Rotation.from_matrix(R_rel).as_rotvec()
    vn = np.sqrt((v * v).sum(1) + 1e-20)
    w = np.minimum(1.0, 0.1 / vn) * valid
    L = np.zeros((n, n))
    np.add.at(L, (ei, ej), -w)
    np.add.at(L, (ej, ei), -w)
    np.add.at(L, (ei, ei), w)
    np.add.at(L, (ej, ej), w)
    g = np.zeros((n, 3))
    np.add.at(g, ei, w[:, None] * v)
    np.add.at(g, ej, -w[:, None] * v)
    L[0, 0] += 1e6
    b = np.linalg.solve(L + 1e-6 * np.eye(n), -g)
    E = Rotation.from_rotvec(b).as_matrix()
    want = np.einsum("nab,cb->nac", E, E[0])
    got, costs = TG.rotation_averaging(n, *_t(ei, ej, R_rel), iters=1,
                                       valid=_t(valid))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(costs.numpy(), [(w * vn * vn).sum()],
                               rtol=1e-9)


@pytest.mark.parametrize("solver", ["rotation", "dense", "cg"])
def test_identity_reduce_is_bit_equal(solver):
    """``reduce`` applied where JAX psums: the identity changes nothing."""
    if solver == "rotation":
        n, ei, ej, x, valid = asymmetric_problem("rotation")
        fn = TG.rotation_averaging
    else:
        n, ei, ej, x, valid = asymmetric_problem("translation")
        fn = {"dense": TG.translation_averaging,
              "cg": TG.translation_averaging_cg}[solver]
    args = (n, *_t(ei, ej, x))
    a = fn(*args, valid=_t(valid))
    b = fn(*args, valid=_t(valid), reduce=lambda y: y)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# ---------------------------------------------------------------------------
# ports of tests/test_global_sfm.py, through the port alone
# ---------------------------------------------------------------------------

def test_rotation_averaging_noise_and_outliers():
    """Port of :33-54."""
    n, ei, ej, R_rel, R_gt = rotation_problem()
    R, costs = TG.rotation_averaging(n, *_t(ei, ej, R_rel))
    R = R.numpy()
    R_ref = np.einsum("nab,cb->nac", R_gt, R_gt[0])
    cos = (np.einsum("nab,nab->n", R, R_ref) - 1) / 2
    errs = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert np.median(errs) < 0.5, np.median(errs)
    assert np.max(errs) < 3.0, np.max(errs)


def test_translation_averaging_noise_and_outliers():
    """Port of :57-82."""
    n, ei, ej, d, C_gt = translation_problem()
    C = TG.translation_averaging(n, *_t(ei, ej, d))[0].numpy()
    s, R, t = umeyama(C, C_gt)
    errs = np.linalg.norm(C @ (s * R).T + t - C_gt, axis=1)
    spread = np.linalg.norm(C_gt - C_gt.mean(0), axis=1).mean()
    assert np.median(errs) < 0.05 * spread, (np.median(errs), spread)
    assert np.sqrt((errs ** 2).mean()) < 0.2 * spread


def test_translation_averaging_cg_matches_dense():
    """Port of :85-108."""
    n, ei, ej, d, _ = translation_problem(5, 24, 0.003, False)
    C_dense = TG.translation_averaging(n, *_t(ei, ej, d))[0].numpy()
    C_cg = TG.translation_averaging_cg(n, *_t(ei, ej, d),
                                       cg_iters=400)[0].numpy()
    scale = _scale(C_dense)
    err = np.linalg.norm(C_cg - C_dense, axis=1)
    assert err.max() < 0.01 * scale, (err.max(), scale)


def test_translation_averaging_cg_scales_to_10k_nodes():
    """Port of :111-140."""
    n, ei, ej, d, C_gt = large_problem()
    C = TG.translation_averaging_cg(n, *_t(ei, ej, d), iters=2,
                                    cg_iters=80)[0].numpy()
    assert np.isfinite(C).all()
    s, R, t = umeyama(C, C_gt)
    errs = np.linalg.norm(C @ (s * R).T + t - C_gt, axis=1)
    spread = np.linalg.norm(C_gt - C_gt.mean(0), axis=1).mean()
    assert np.median(errs) < 0.05 * spread, (np.median(errs), spread)
