"""popsift_tpu_torch.ops.matching and FeaturesDev.match against the JAX
package on the CPU, on the same numpy inputs made from seeds.

Tolerances: indices and ``accept`` equal on valid rows, distances within
1e-5 (tests/test_matching.py:34); the q8 matcher equal in every field,
bit for bit; with planted exact ties ``second_idx`` equal to JAX's on
every row (the stable merge); the pruned matcher equal to the exhaustive
one when the shortlist covers the right set, and with a 64-row
shortlist recall >= 0.99 against exhaustive and >= 99 % agreement with
JAX's pruned result; the sketch basis's projector within 1e-4.
"""

import numpy as np
import pytest
import torch

from popsift_tpu.api import PopSift as JaxPopSift
from popsift_tpu.config import SiftConfig as JaxSiftConfig
from popsift_tpu.ops import matching as JM
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch.config import SiftConfig as PortSiftConfig
from popsift_tpu_torch.ops import matching as TM

torch.set_num_threads(1)


def _rand_desc(n, seed):
    r = np.random.default_rng(seed)
    d = np.abs(r.standard_normal((n, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d


def _cloud(seed, n):
    """Clustered SIFT-like descriptors and noisy permuted copies
    (tests/test_matching.py:124-135)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, 128)).astype(np.float32)
    dl = (centers[rng.integers(0, 32, n)]
          + 0.35 * rng.normal(size=(n, 128))).astype(np.float32)
    dl = np.abs(dl)
    dl /= np.linalg.norm(dl, axis=1, keepdims=True)
    dr = dl[rng.permutation(n)] + 0.05 * rng.normal(size=(n, 128)).astype(
        np.float32)
    dr = np.abs(dr).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    return dl, dr


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np(res):
    return [np.asarray(f) for f in res]


def _assert_same_match(port, jax_res, rows, atol=1e-5):
    p, j = _np(port), _np(jax_res)
    for k in (0, 1, 4):                    # best_idx, second_idx, accept
        np.testing.assert_array_equal(p[k][rows], j[k][rows])
    for k in (2, 3):                       # best_dist, second_dist
        np.testing.assert_allclose(p[k][rows], j[k][rows], atol=atol)


@pytest.mark.parametrize("tile", [64, 50, 4096],
                         ids=["tile64", "ragged50", "one_tile"])
def test_tiled_matches_jax(tile):
    dl, dr = _rand_desc(97, 0), _rand_desc(201, 1)
    vl = np.ones(97, bool)
    vl[90:] = False
    vr = np.ones(201, bool)
    vr[13] = False
    vr[150:170] = False
    got = TM.match_descriptors(*_t(dl, vl, dr, vr), tile=tile)
    want = JM.match_descriptors(dl, vl, dr, vr, tile=tile)
    _assert_same_match(got, want, vl)
    assert not got.accept[~torch.from_numpy(vl)].any()
    brute = TM.match_brute_small(*_t(dl, vl, dr, vr))
    _assert_same_match(got, brute, vl)


def _tie_case(case):
    """Integer-valued descriptors, so every distance is exact in both
    packages and equal distances are exact ties. Right rows 8..15 (one
    whole tile of 8) are invalid; ``dupes`` repeats rows across tiles;
    ``one`` and ``none`` leave one valid right row and none."""
    rng = np.random.default_rng(7)
    dl = rng.integers(0, 3, (12, 128)).astype(np.float32)
    dr = rng.integers(0, 3, (37, 128)).astype(np.float32)
    dr[20] = dr[3]                   # the same row in tiles 0, 2 and 4
    dr[33] = dr[3]
    dr[30] = dl[5]                   # an exact match, and its duplicate
    dr[35] = dl[5]
    dl[7] = dl[5]
    vl = np.ones(12, bool)
    vl[10] = False
    vr = np.ones(37, bool)
    vr[8:16] = False
    if case == "one":
        vr[:] = False
        vr[30] = True
    elif case == "none":
        vr[:] = False
    return dl, vl, dr, vr


@pytest.mark.parametrize("case", ["dupes", "one", "none"])
def test_planted_ties_follow_jax(case):
    """Exact ties, including the inf entries of invalid rows and of the
    initial carry, merge the way JAX's stable argsort merges them: every
    field equal on every row, second_idx included."""
    dl, vl, dr, vr = _tie_case(case)
    results = {}
    for q8 in (False, True):
        fn_t = TM.match_descriptors_q8 if q8 else TM.match_descriptors
        fn_j = JM.match_descriptors_q8 if q8 else JM.match_descriptors
        got = results[q8] = _np(fn_t(*_t(dl, vl, dr, vr), tile=8))
        want = _np(fn_j(dl, vl, dr, vr, tile=8))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    exact = results[False]
    if case == "dupes":
        # rows 5 and 7 have two exact matches at distance 0: the lower
        # index is best, the other second, and 0 / max(0, 1e-30) passes
        # the ratio test
        for row in (5, 7):
            assert (exact[0][row], exact[1][row], exact[2][row],
                    exact[3][row], exact[4][row]) == (30, 35, 0.0, 0.0, True)
    if case == "one":
        # no second candidate: second_idx is the initial carry's 0
        assert np.isinf(exact[3]).all() and (exact[1] == 0).all()


def test_q8_equals_jax_bit_for_bit():
    dl, dr = _cloud(21, 512)
    vl = np.ones(512, bool)
    vl[502:] = False
    vr = np.ones(512, bool)
    vr[::37] = False
    got = _np(TM.match_descriptors_q8(*_t(dl, vl, dr, vr), tile=100))
    want = _np(JM.match_descriptors_q8(dl, vl, dr, vr, tile=100))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_q8_matcher_recall_vs_exact():
    """Port of tests/test_matching.py:177-210 on the port alone."""
    dl, dr = _cloud(21, 512)
    vl = np.ones(512, bool)
    vl[502:] = False
    vr = np.ones(512, bool)
    exact = _np(TM.match_descriptors(*_t(dl, vl, dr, vr)))
    q8 = _np(TM.match_descriptors_q8(*_t(dl, vl, dr, vr)))
    acc_e, acc_q = exact[4], q8[4]
    assert not acc_q[~vl].any()
    assert ((exact[0] == q8[0]) & acc_q)[acc_e].mean() >= 0.99
    np.testing.assert_allclose(q8[2][acc_e], exact[2][acc_e], atol=0.02)


def test_pruned_exact_when_shortlist_covers():
    rng = np.random.default_rng(4)
    L, R = 96, 80
    dl = rng.normal(size=(L, 128)).astype(np.float32)
    dr = rng.normal(size=(R, 128)).astype(np.float32)
    dl /= np.linalg.norm(dl, axis=1, keepdims=True)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    vl = rng.random(L) < 0.9
    vr = rng.random(R) < 0.9
    got = TM.match_descriptors_pruned(*_t(dl, vl, dr, vr), shortlist=R)
    exhaustive = TM.match_descriptors(*_t(dl, vl, dr, vr))
    want = JM.match_descriptors_pruned(dl, vl, dr, vr, shortlist=R)
    for other in (exhaustive, want):
        _assert_same_match(got, other, vl)
    np.testing.assert_array_equal(np.asarray(got.accept), np.asarray(
        want.accept))


def test_pruned_recall_and_agreement_with_jax():
    """The 1024-descriptor cloud of tests/test_matching.py:119-149 with a
    64-row shortlist: recall >= 0.99 against the exhaustive matcher, and
    >= 99 % of JAX's accepted rows matched alike."""
    dl, dr = _cloud(9, 1024)
    vl = vr = np.ones(1024, bool)
    exhaustive = _np(TM.match_descriptors(*_t(dl, vl, dr, vr)))
    got = _np(TM.match_descriptors_pruned(*_t(dl, vl, dr, vr),
                                          sketch_dim=16, shortlist=64))
    want = _np(JM.match_descriptors_pruned(dl, vl, dr, vr, sketch_dim=16,
                                           shortlist=64))
    wa = exhaustive[4]
    assert ((got[0] == exhaustive[0]) & got[4])[wa].mean() >= 0.99
    ja = want[4]
    assert ((got[0] == want[0]) & (got[4] == ja))[ja].mean() >= 0.99


def test_sketch_basis_projector_matches_jax():
    dr = _rand_desc(300, 5)
    vr = np.ones(300, bool)
    vr[250:] = False
    P, mu = JM.sketch_basis(dr, vr, 16)
    Pt, mut = TM.sketch_basis(*_t(dr, vr), 16)
    P, Pt = np.asarray(P), Pt.numpy()
    np.testing.assert_allclose(Pt @ Pt.T, P @ P.T, atol=1e-4)
    np.testing.assert_allclose(mut.numpy(), np.asarray(mu), atol=1e-6)
    np.testing.assert_allclose(Pt.T @ Pt, np.eye(16), atol=1e-5)


def test_ratio_test_semantics():
    """Port of tests/test_matching.py:43-60: a planted pair with a clear
    margin is accepted, an ambiguous one rejected."""
    base = _rand_desc(8, 2)
    dl = base.copy()
    dr = np.concatenate([base + 0.001, _rand_desc(32, 3)], axis=0)
    dr[20] = dl[3] - 0.001
    got = TM.match_descriptors(*_t(dl, np.ones(8, bool), dr,
                                   np.ones(40, bool)))
    for i in range(8):
        if i == 3:
            assert not got.accept[i]
        else:
            assert got.accept[i] and got.best_idx[i] == i


def test_matcher_agrees_with_cv2_bfmatcher():
    """Port of tests/test_matching.py:152-174."""
    cv2 = pytest.importorskip("cv2")
    dl, dr = _rand_desc(150, 7), _rand_desc(220, 8)
    got = TM.match_descriptors(*_t(dl, np.ones(150, bool), dr,
                                   np.ones(220, bool)))
    knn = cv2.BFMatcher(cv2.NORM_L2).knnMatch(dl, dr, k=2)
    best = np.array([m[0].trainIdx for m in knn])
    d1 = np.array([m[0].distance for m in knn], np.float64) ** 2
    d2 = np.array([m[1].distance for m in knn], np.float64) ** 2
    np.testing.assert_array_equal(got.best_idx.numpy(), best)
    np.testing.assert_allclose(got.best_dist.numpy(), d1, atol=1e-4)
    np.testing.assert_array_equal(got.accept.numpy(),
                                  d1 / np.maximum(d2, 1e-30) < 0.8)


def test_tf32_switch_is_restored():
    """The matcher runs its products in full f32 and leaves the caller's
    TF32 switch as it found it."""
    dl, dr = _rand_desc(40, 11), _rand_desc(50, 12)
    v = np.ones(50, bool)
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        got = TM.match_descriptors(*_t(dl, v[:40], dr, v))
        assert matmul.allow_tf32 is True
        matmul.allow_tf32 = False
        want = TM.match_descriptors(*_t(dl, v[:40], dr, v))
        assert matmul.allow_tf32 is False
    finally:
        matmul.allow_tf32 = was
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def small_pair(small_image):
    """FeaturesDev of small_image and of its (3, 5) roll from both
    packages (matching mode, octaves=2), extracted once."""
    imgs = (small_image, np.roll(small_image, (3, 5), axis=(0, 1)))
    jps = JaxPopSift(JaxSiftConfig(octaves=2), mode="matching")
    tps = tapi.PopSift(PortSiftConfig(octaves=2), mode="matching",
                       device="cpu")
    return ([jps.enqueue(im).getDev() for im in imgs],
            [tps.enqueue(im).getDev() for im in imgs])


def test_self_match_through_both_apis(small_pair):
    (ja, _), (ta, _) = small_pair
    valid = ta.desc_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ja.desc_valid))
    assert valid.sum() > 0
    rows = np.nonzero(valid)[0]
    for res in (ta.match(ta), ja.match(ja)):
        np.testing.assert_array_equal(np.asarray(res.best_idx)[valid], rows)
        assert np.asarray(res.best_dist)[valid].max() < 1e-6


def test_shifted_match_through_both_apis(small_pair):
    (ja, jb), (ta, tb) = small_pair
    got, want = ta.match(tb), ja.match(jb)
    valid = ta.desc_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ja.desc_valid))
    np.testing.assert_array_equal(got.best_idx.numpy()[valid],
                                  np.asarray(want.best_idx)[valid])
    np.testing.assert_array_equal(got.accept.numpy(),
                                  np.asarray(want.accept))
    assert int(got.accept.sum()) > 0.5 * ta.getDescriptorCount()
