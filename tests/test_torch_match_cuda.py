"""popsift-match on the card: matching-mode extraction of the bench
frame, the matchers against their CPU runs, the exact matcher's kernel
(``csrc/match.cu``) against the plain version on the same card, RANSAC
on the card against a known shift and against the CPU from the same
ranks, and the match CLI.

These tests need a CUDA device (and nvcc, to build popsift_tpu_torch/csrc
on first use); they skip without one. On the card:

    python -m pytest tests/test_torch_match_cuda.py -q --noconftest -m cuda

The pair is ``bench.make_frame`` at 1920 x 1080 (seed 0) against its
(3, 5) roll and against seed 1, extracted with
``PopSift(SiftConfig(extrema_capacity=8192), mode="matching")``. The
kernel's sets are seeded unit descriptors in the pair cell's per-octave
layout (29,450 padded rows a side, about 4 % valid) and at other sizes.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from popsift_tpu_torch.api import PopSift
from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.ops import matching as M
from popsift_tpu_torch.ops.kernels import match as K
from popsift_tpu_torch.sfm import twoview as T
from popsift_tpu_torch.utils import profiling
from torch_card import (BENCH_DESCRIPTORS, BENCH_KEYPOINTS, FRAME_HW,
                        PAIR_NEAR_TIE, card_device, match_differences,
                        tie_case, without_syncs)

pytestmark = pytest.mark.cuda

SHIFT = (3, 5)
# the pair cell (SiftConfig() at 800 x 640): the descriptor rows of each
# octave, and a valid prefix of each near the cell's counts (1,256 rows,
# 4.3 % of 29,450)
CELL_CAPS = (20000, 5000, 1250, 640, 640, 640, 640, 640)
CELL_VALID = (160, 350, 380, 300, 60, 6, 0, 0)
# (left caps, left valid, right caps, right valid) of each kernel case
KERNEL_SETS = {
    "cell": (CELL_CAPS, CELL_VALID, CELL_CAPS, CELL_VALID),
    "l_ne_r": ((3000, 1000, 517), (400, 200, 90),
               (5000, 2100, 333), (350, 260, 60)),
    "ragged": ((1001,), (990,), (777,), (770,)),
    "one_valid": ((700,), (300,), (600,), (1,)),
    "no_valid": ((700,), (300,), (600,), (0,)),
}


@pytest.fixture(scope="module")
def pair():
    """Frame 0, its (3, 5) roll and seed 1, each extracted in matching
    mode on the card."""
    dev = card_device()
    import bench
    f0, f1 = (bench.make_frame(*FRAME_HW, seed=s) for s in (0, 1))
    fs = np.roll(f0, SHIFT, axis=(0, 1))
    ps = PopSift(SiftConfig(extrema_capacity=8192), mode="matching",
                 device=dev)
    d0, ds, d1 = (ps.enqueue(f).get() for f in (f0, fs, f1))
    return dict(dev=dev, f0=f0, fs=fs, d0=d0, ds=ds, d1=d1,
                exact=d0.match(ds))


def test_matching_mode_extracts_the_bench_frame(pair):
    d0 = pair["d0"]
    assert (d0.getFeatureCount(), d0.getDescriptorCount()) \
        == (BENCH_KEYPOINTS, BENCH_DESCRIPTORS)


def test_self_match(pair):
    """Each valid row of frame 0 matches itself, or an earlier row whose
    descriptor repeats it bit for bit (the first minimal column, as
    JAX's argmin), at distance < 1e-6."""
    d0 = pair["d0"]
    own = d0.match(d0)
    live = d0.desc_valid.nonzero().squeeze(1)
    best = own.best_idx[live]
    other = best != live
    assert torch.equal(d0.descriptors[best[other]],
                       d0.descriptors[live[other]])
    assert (best[other] < live[other]).all()
    assert float(own.best_dist[live].max()) < 1e-6


@pytest.mark.parametrize("right", ["ds", "d1"], ids=["shifted", "seed_1"])
def test_exact_matcher_equals_the_cpu(pair, right):
    """Frame 0 against the roll and against seed 1: the card against the
    CPU run of the same matcher on the valid rows, distances within
    1e-4, indices and accepts differing (near-ties) on at most 0.1 % of
    the valid rows."""
    d0, dr = pair["d0"], pair[right]
    v0 = d0.desc_valid
    n_valid = int(v0.sum())
    got = d0.match(dr)
    live = v0.nonzero().squeeze(1)
    ref = M.match_descriptors(d0.descriptors[live].cpu(), v0[live].cpu(),
                              dr.descriptors.cpu(), dr.desc_valid.cpu())
    g = [f[live].cpu() for f in got]
    for k in (2, 3):
        assert torch.isclose(g[k], ref[k], rtol=0, atol=1e-4).all(), k
    ties = ((g[0] != ref.best_idx) | (g[1] != ref.second_idx)
            | (g[4] != ref.accept))
    assert int(ties.sum()) <= 1e-3 * n_valid


def test_matcher_ignores_tf32(pair):
    """The matcher with TF32 on equals the run with it off in every
    field, and restores the switch."""
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        tf32 = pair["d0"].match(pair["ds"])
        restored = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = False
    assert restored
    for a, b in zip(tf32, pair["exact"]):
        assert torch.equal(a, b)


def test_q8_and_pruned_matchers(pair):
    """q8 equal to its CPU run in every field; q8 and pruned keep the
    exact matcher's nearest neighbour on at least 99 % of its accepted
    rows, pruned also its accepts. (The q8 ratio test flips accepts whose
    exact ratio lies near 0.8: a tenth of frame 0 / shifted's accepted
    rows lie above 0.68.)"""
    d0, ds, ex = pair["d0"], pair["ds"], pair["exact"]
    v0 = d0.desc_valid
    live = v0.nonzero().squeeze(1)
    args = (d0.descriptors, v0, ds.descriptors, ds.desc_valid)
    q8 = M.match_descriptors_q8(*args)
    ref = M.match_descriptors_q8(d0.descriptors[live].cpu(), v0[live].cpu(),
                                 ds.descriptors.cpu(), ds.desc_valid.cpu())
    for a, b in zip(q8, ref):
        assert torch.equal(a[live].cpu(), b)
    for name, r in (("q8", q8), ("pruned", M.match_descriptors_pruned(*args))):
        same = (r.best_idx == ex.best_idx)[ex.accept]
        recall = float((same & r.accept[ex.accept]).float().mean())
        nearest = float(same.float().mean())
        assert nearest >= 0.99, (name, nearest)
        assert name == "q8" or recall >= 0.99, (name, recall)


def test_homography_ransac_finds_the_shift(pair):
    """Homography RANSAC on frame 0 / shifted's accepted matches: at least
    90 % of the matches that the known shift moves within the 2 px gate
    are inliers, no inlier lies 2.5 px or more off it, the inliers' mean
    shift is within 0.05 px of it and the model's corners within 0.5 px.
    (The ratio test accepts wrong matches too, a quarter of this pair's
    lying tens of px off; a 4-point hypothesis carries its points' noise,
    0.08 px median, to the corners.)"""
    dev, d0, ds, ex = pair["dev"], pair["d0"], pair["ds"], pair["exact"]
    acc = ex.accept.nonzero().squeeze(1)
    lk, rk = d0.raw.desc_kp[acc], ds.raw.desc_kp[ex.best_idx[acc]]
    n_acc = acc.numel()
    cap = max(64, 1 << (n_acc - 1).bit_length())
    pl = torch.zeros(cap, 2, device=dev)
    pr = torch.zeros(cap, 2, device=dev)
    pl[:n_acc] = torch.stack([d0.raw.x[lk], d0.raw.y[lk]], 1)
    pr[:n_acc] = torch.stack([ds.raw.x[rk], ds.raw.y[rk]], 1)
    vmask = torch.arange(cap, device=dev) < n_acc
    gen = torch.Generator(device=dev).manual_seed(0)
    hom = T.ransac_homography(gen, pl, pr, vmask, thresh=4.0, n_hyp=512)
    H = hom.model.double().cpu()
    h, w = pair["f0"].shape
    corners = torch.tensor([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                            [w - 1, h - 1, 1]], dtype=torch.float64)
    mapped = corners @ H.T
    true = torch.tensor([SHIFT[1], SHIFT[0]], dtype=torch.float64)
    moved = mapped[:, :2] / mapped[:, 2:] - corners[:, :2]
    corner_err = float((moved - true).abs().max())
    disp = (pr - pl)[:n_acc].double().cpu()
    off = (disp - true).norm(dim=1)
    inl = hom.inliers[:n_acc].cpu()
    ls_err = float((disp[inl].mean(0) - true).abs().max())
    n_inl, n_true = int(hom.n_inliers), int((off < 2.0).sum())
    assert n_inl >= 0.9 * n_true
    assert int((inl & (off >= 2.5)).sum()) == 0
    assert ls_err <= 0.05 and corner_err <= 0.5, (ls_err, corner_err)


def _synthetic_pairs(seed: int, n_edges: int, n: int = 1000):
    """Seeded two-view scenes: normalized observations of points in a wide
    field of view from cameras 15 degrees and a unit baseline apart,
    3e-4 noise, a fifth of each edge's rows outliers, the last rows of
    each edge invalid. Returns (x1, x2, valid) as f32/bool [B, N, .]."""
    rng = np.random.default_rng(seed)
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    a = np.deg2rad(15.0)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    x1s, x2s, vs = [], [], []
    for e in range(n_edges):
        X = rng.uniform([-3, -3, 2], [3, 3, 5], size=(n, 3))
        Xc = X @ R.T + np.array([1.0, 0.2 * e, 0.3])
        x1 = X[:, :2] / X[:, 2:3] + rng.normal(0, 3e-4, (n, 2))
        x2 = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 3e-4, (n, 2))
        x2[: n // 5] = rng.uniform(-1, 1, (n // 5, 2))
        valid = np.arange(n) < n - 10 * (e + 1)
        x1s.append(x1)
        x2s.append(x2)
        vs.append(valid)
    return (torch.from_numpy(np.stack(x1s).astype(np.float32)),
            torch.from_numpy(np.stack(x2s).astype(np.float32)),
            torch.from_numpy(np.stack(vs)))


def test_essential_ransac_equals_the_cpu(pair):
    """Essential RANSAC on a seeded scene, on the card against the CPU
    from the same ranks: the model within 1e-4 after scale and sign are
    normalised, or a different hypothesis whose MSAC score lies within
    1e-6 relative (the chosen 8-point hypothesis's f32 null vector
    differs between the two SVD solvers by about its condition number x
    eps); the inlier masks equal except points whose error under the CPU
    model lies within 1e-4 relative of the gate."""
    dev = pair["dev"]
    x1, x2, vv = _synthetic_pairs(0, 3)
    ranks = T.draw_ranks(torch.Generator().manual_seed(1), vv, 512, 8)
    thresh = 1e-5
    ref = T.ransac_essential(None, x1[0], x2[0], vv[0], thresh,
                             ranks=ranks[0])
    got = T.ransac_essential(None, x1[0].to(dev), x2[0].to(dev),
                             vv[0].to(dev), thresh, ranks=ranks[0].to(dev))
    a = ref.model.flatten() / ref.model.norm()
    b = got.model.cpu().flatten() / got.model.norm().cpu()
    b = b if float(a @ b) >= 0 else -b
    model_err = float((a - b).abs().max())
    s_ref, s_got = float(ref.score), float(got.score)
    assert model_err <= 1e-4 or abs(s_got - s_ref) <= 1e-6 * abs(s_ref)
    err = T.sampson_error(ref.model[None], x1[0], x2[0])[0]
    near = (err - thresh).abs() <= 1e-4 * thresh
    differ = got.inliers.cpu() != ref.inliers
    assert not (differ & ~near & vv[0]).any()


def test_solve_pairs_batch_equals_the_cpu(pair):
    """``solve_pairs_batch`` of three seeded edges on the card against the
    CPU from the same ranks: R and t within 1e-4, the good rows' points
    within 1e-4 relative, the good rows equal."""
    dev = pair["dev"]
    x1, x2, vv = _synthetic_pairs(0, 3)
    ranks = T.draw_ranks(torch.Generator().manual_seed(1), vv, 512, 8)
    thresh = 1e-5
    ref = T.solve_pairs_batch(None, x1, x2, vv, thresh, ranks=ranks)
    got = [a.cpu() for a in T.solve_pairs_batch(
        None, x1.to(dev), x2.to(dev), vv.to(dev), thresh,
        ranks=ranks.to(dev))]
    good = ref[2]
    x_err = ((got[3] - ref[3]).abs().amax(-1) / ref[3].norm(dim=-1))[good]
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4
    assert float((got[1] - ref[1]).abs().max()) <= 1e-4
    assert float(x_err.max()) <= 1e-4
    assert torch.equal(got[2], good)


def test_match_cli_equals_the_api(pair, tmp_path):
    """The match CLI (no capacity flag: ``SiftConfig()``) with ``--device
    cuda --geom homography`` on frame 0 / shifted written as PGM: exit
    0, as many accepted matches as the API run with the same
    configuration, one geometric verification line."""
    from popsift_tpu_torch.cli import match as match_cli
    from popsift_tpu_torch.io.image import write_pgm
    dev, f0, fs = pair["dev"], pair["f0"], pair["fs"]
    dflt = PopSift(SiftConfig(), mode="matching", device=dev)
    e0, es = dflt.enqueue(f0).get(), dflt.enqueue(fs).get()
    api_acc = int(e0.match(es).accept.sum())
    paths = [os.path.join(tmp_path, n) for n in ("f0.pgm", "shifted.pgm")]
    write_pgm(paths[0], f0)
    write_pgm(paths[1], fs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = match_cli.main(["-l", paths[0], "-r", paths[1], "--device",
                             str(dev), "--geom", "homography"])
    lines = out.getvalue().splitlines()
    cli_acc = int([l for l in lines if l.startswith("accepted matches:")][0]
                  .split(": ")[1])
    geom = [l for l in lines if l.startswith("geometric verification")]
    assert rc == 0 and cli_acc == api_acc and len(geom) == 1


def _unit(gen, n: int) -> torch.Tensor:
    x = torch.rand(n, 128, generator=gen, dtype=torch.float64) ** 2
    return x / x.norm(dim=1, keepdim=True)


def _octave_sets(seed: int, caps_l, valid_l, caps_r, valid_r):
    """Padded f32 descriptor sets on the CPU in the per-octave layout:
    octave o owns ``caps[o]`` rows, its first ``valid[o]`` valid
    non-negative unit descriptors (as RootSIFT's), the rest zeros. Three
    in four of an octave's valid right rows are the left's of the same
    octave in another order with noise; the others are drawn anew."""
    gen = torch.Generator().manual_seed(seed)

    def layout(caps, valid, rows):
        d = torch.zeros(sum(caps), 128, dtype=torch.float64)
        v = torch.zeros(sum(caps), dtype=torch.bool)
        o0 = 0
        for cap, n, r in zip(caps, valid, rows):
            d[o0:o0 + n], v[o0:o0 + n] = r, True
            o0 += cap
        return d.float(), v

    left = [_unit(gen, n) for n in valid_l]
    right = []
    for o, n in enumerate(valid_r):
        r = _unit(gen, n)
        src = left[o] if o < len(left) else r[:0]
        k = min(3 * n // 4, src.shape[0])
        pick = torch.randperm(src.shape[0], generator=gen)[:k]
        noisy = (src[pick] + 0.03 * torch.randn(
            k, 128, generator=gen, dtype=torch.float64)).abs()
        r[:k] = noisy / noisy.norm(dim=1, keepdim=True)
        right.append(r)
    return (*layout(caps_l, valid_l, left), *layout(caps_r, valid_r, right))


def _plain(dl, vl, dr, vr, ratio=M.RATIO):
    """The plain version's ``MatchResult`` on the tensors' device."""
    b_d, b_i, s_d, s_i = K.match_top2_torch(dl, dr, vr)
    return M.MatchResult(b_i, s_i, b_d, s_d, M._accept(b_d, s_d, vl, ratio))


@pytest.fixture(scope="module")
def kernel_sets():
    """Each case of ``KERNEL_SETS`` on the card, with its plain result
    run on the card."""
    dev = card_device()
    out = {}
    for seed, (case, shape) in enumerate(KERNEL_SETS.items()):
        sets = tuple(t.to(dev) for t in _octave_sets(seed, *shape))
        out[case] = (sets, _plain(*sets))
    return out


@pytest.mark.parametrize("case", list(KERNEL_SETS))
def test_kernel_equals_the_plain_path(kernel_sets, case):
    """The kernel against the plain version on the same card: the pair
    cell's padded sets, L != R, sizes that are multiples of no tile, a
    right set with one valid row and with none. Distances within
    ``MATCH_DIST_TOL`` (the kernel's FMA chain and cuBLAS's product sum
    in other orders), columns and accepts equal except near-ties, on at
    most ``PAIR_NEAR_TIE`` of the valid left rows."""
    (dl, vl, dr, vr), want = kernel_sets[case]
    got = M.match_descriptors(dl, vl, dr, vr)
    n_valid = int(vl.sum())
    assert match_differences(got, want, dl, dr, vl) \
        <= PAIR_NEAR_TIE * n_valid
    if case in ("one_valid", "no_valid"):
        for k in ("best_idx", "second_idx", "accept"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_kernel_is_deterministic_counted_and_makes_no_sync(kernel_sets):
    """The pair cell's sets three times: bit-equal results, the launch
    count up by one a call, ``match.calls`` and ``match.kernel`` up by
    one a call while tracing, and no host synchronisation (sync debug
    mode "error")."""
    (dl, vl, dr, vr), _ = kernel_sets["cell"]
    before = K.launches
    profiling.reset()
    profiling.enable_tracing(True)
    try:
        runs = [without_syncs(lambda: M.match_descriptors(dl, vl, dr, vr))
                for _ in range(3)]
        torch.cuda.synchronize()
        counters = profiling.counters()
    finally:
        profiling.enable_tracing(False)
        profiling.reset()
    assert K.launches - before == 3
    assert (counters["match.calls"], counters["match.kernel"]) == (3, 3)
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("side", ["left", "right"])
def test_kernel_empty_sets(kernel_sets, side):
    """No left row: empty fields; no right row: the plain version's fill
    values (inf, 0), (inf, 0), no accept. Neither launches."""
    (dl, vl, dr, vr), _ = kernel_sets["ragged"]
    if side == "left":
        dl, vl = dl[:0], vl[:0]
    else:
        dr, vr = dr[:0], vr[:0]
    before = K.launches
    got = M.match_descriptors(dl, vl, dr, vr)
    want = _plain(dl, vl, dr, vr)
    assert K.launches == before
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("case", ["dupes", "one", "none"])
def test_kernel_planted_ties(case):
    """The CPU's planted ties on the card: every field of the kernel's
    result equal to the CPU's plain run, second_idx included; ``dupes``
    rows 5 and 7 read (30, 35, 0.0, 0.0, True): the kernel's norms and
    products are one chain, so an exact duplicate reads 0 exactly."""
    dev = card_device()
    dl, vl, dr, vr = (torch.from_numpy(a) for a in tie_case(case))
    got = M.match_descriptors(dl.to(dev), vl.to(dev), dr.to(dev), vr.to(dev))
    want = M.match_descriptors(dl, vl, dr, vr, tile=8)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case == "dupes":
        for row in (5, 7):
            assert (int(got.best_idx[row]), int(got.second_idx[row]),
                    float(got.best_dist[row]), float(got.second_dist[row]),
                    bool(got.accept[row])) == (30, 35, 0.0, 0.0, True)
