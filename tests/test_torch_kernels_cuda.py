"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests need a CUDA
device (and nvcc, to build popsift_tpu_torch/csrc on first use); they
skip without one. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances: blur/DoG levels (K5 and the chain K7), masks, window copies
and refinement state exact (the kernels are built with -fmad=false and
follow the plain version op for op); histograms and descriptors, the
patch-fed and bucketed entries included, within 1e-5 x the row's max
(fixed-order sums in another order than the plain version's reductions).
K1's, K3's and K4's launches over several octaves equal their
single-octave launches bit for bit, and two runs of K3 and K4 give the
same bits. The compaction equals its plain version entry for entry and
K2's all-octave launch equals its plain version bit for bit, and an
extraction of an uploaded frame runs with no stream synchronisation.
The all-octave launches of K2, K3 and K4 with the row bounds of a band
(``parallel/spatial.py``) against their plain versions by the same
tolerances, counted on their own; with whole-frame bounds bit-equal to
the unbounded launch.
"""

import math

import numpy as np
import pytest
import torch

from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.gauss import build_gauss_tables, full_kernel
from popsift_tpu_torch.ops import extrema, patches
from popsift_tpu_torch.ops import pyramid as pyr
from popsift_tpu_torch.ops.kernels import (blur_chain, blur_dog, compact,
                                           desc, extrema_mask, orient, refine,
                                           window)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _dog(dev, D=5, H=97, W=131, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(D, H, W)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (1, 2):
        base = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, base)
    return torch.from_numpy((base * 60).astype(np.float32)).to(dev)


def _rel_rows(got, ref):
    rowmax = ref.abs().amax(1, keepdim=True)
    return bool(((got - ref).abs() <= 1e-5 * rowmax + 1e-30).all())


def test_extrema_mask_kernel(dev):
    dog = _dog(dev)
    before = extrema_mask.launches
    got = extrema_mask.candidate_mask(dog, 2.72)
    assert extrema_mask.launches == before + 1
    ref = extrema_mask.candidate_mask_torch(dog, 2.72)
    assert ref.sum() > 0 and torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(5, 97, 131), (5, 64, 244), (3, 9, 15),
                                   (8, 33, 40), (5, 1, 7), (5, 2, 2)])
def test_extrema_mask_kernel_shapes(dev, shape):
    """Odd and aligned widths, several strips and bands, stacks of other
    depths than five, planes without an interior."""
    dog = _dog(dev, *shape, seed=shape[1])
    got = extrema_mask.candidate_mask(dog, 2.72)
    assert torch.equal(got, extrema_mask.candidate_mask_torch(dog, 2.72))


@pytest.mark.parametrize("F", [1, 3])
def test_extrema_mask_octaves_kernel(dev, F):
    """One launch over four octaves of F frames: bool views, equal to the
    plain version and to the single-octave and batched entries, one
    launch counted."""
    dims = [(96, 244), (48, 122), (24, 61), (12, 31)]
    dogs = [torch.cat([_dog(dev, 5, h, w, seed=10 * f + h) for f in range(F)])
            for h, w in dims]
    before = (extrema_mask.launches_octaves, extrema_mask.launches,
              extrema_mask.launches_batched)
    got = extrema_mask.candidate_mask_octaves(dogs, 2.72, F)
    torch.cuda.synchronize(dev)
    assert (extrema_mask.launches_octaves, extrema_mask.launches,
            extrema_mask.launches_batched) == (before[0] + 1, *before[1:])
    ref = extrema_mask.candidate_mask_octaves_torch(dogs, 2.72, F)
    for d, g, r in zip(dogs, got, ref):
        assert g.dtype == torch.bool and g.shape == (F, 3, *d.shape[1:])
        assert r.sum() > 0 and torch.equal(g, r)
        assert torch.equal(g.view(torch.uint8),
                           extrema_mask.candidate_mask_batched(d, F, 2.72))
        assert torch.equal(g[F - 1].view(torch.uint8),
                           extrema_mask.candidate_mask(d[5 * (F - 1):], 2.72))


@pytest.mark.parametrize("vlfeat", [False, True])
def test_refine_kernel(dev, vlfeat):
    cfg = SiftConfig(sift_mode="vlfeat" if vlfeat else "popsift")
    dog = _dog(dev, seed=1)
    cand = extrema.collect_candidates(dog, cfg, 512)
    n = int(cand.n_found)
    assert n > 0
    args = (dog, cand.x0, cand.y0, cand.z0, n)
    got = refine.refine_state(*args, maxlevel=5, vlfeat=vlfeat)
    ref = refine.refine_state_torch(*args, maxlevel=5, vlfeat=vlfeat)
    assert torch.equal(got, ref)


def _keypoints(dev, L, H, W, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    return (f(rng.uniform(0, W - 1, n).astype(np.float32)),
            f(rng.uniform(0, H - 1, n).astype(np.float32)),
            f(rng.uniform(1.6, 5.1, n).astype(np.float32)),
            f(rng.integers(0, L, n).astype(np.int64)),
            f(rng.uniform(-math.pi, math.pi, n).astype(np.float32)),
            f(rng.random(n) < 0.9))


def test_orientation_kernel(dev):
    blur = torch.rand((6, 90, 120), device=dev) * 255
    x, y, s, lv, _, valid = _keypoints(dev, 6, 90, 120, 200, seed=2)
    got = orient.orientation_hist(blur, x, y, s, lv, valid, 180, 23)
    ref = orient.orientation_hist_torch(blur, x, y, s, lv, valid, 180, 23)
    assert torch.all(got[180:] == 0) and _rel_rows(got, ref)


@pytest.mark.parametrize("F", [1, 2])
def test_orientation_octaves_kernel(dev, F):
    """One launch over three octaves of F frames (one octave without a
    valid row) equals the single-octave launches on each frame's own
    layers bit for bit, writes zeros for rows that are not valid into an
    output it did not fill, counts one launch, gives the same bits twice."""
    shapes = [(6, 140, 170, 96), (6, 70, 85, 40), (6, 35, 43, 24)]
    blurs = [torch.rand((F * L, H, W), device=dev) * 255
             for L, H, W, _ in shapes]
    ends = np.cumsum([n for *_, n in shapes]).tolist()
    cols, singles = [], []
    for f in range(F):
        for o, (L, H, W, n) in enumerate(shapes):
            x, y, s, lv, _, valid = _keypoints(dev, L, H, W, n,
                                               seed=30 + 3 * f + o)
            s = s.clamp(max=0.04 * min(H, W) + 1.7)
            if o == 1:
                valid = torch.zeros_like(valid)
            cols.append((x, y, s, lv, valid))
            singles.append(orient.orientation_hist(
                blurs[o][f * L:(f + 1) * L], x, y, s, lv, valid, n, 23))
    args = [torch.cat([c[i] for c in cols]) for i in range(5)]
    b0, b1 = orient.launches_octaves, orient.launches
    got = orient.orientation_hist_octaves(blurs, ends, *args, 23, F)
    assert (orient.launches_octaves, orient.launches) == (b0 + 1, b1)
    assert torch.equal(got, torch.cat(singles))
    assert torch.all(got[~args[4]] == 0) and got[args[4]].abs().sum() > 0
    assert torch.equal(got, orient.orientation_hist_octaves(
        blurs, ends, *args, 23, F))
    assert _rel_rows(got, orient.orientation_hist_octaves_torch(
        blurs, ends, *args, 23, F))


def test_descriptor_kernel(dev):
    blur = torch.rand((6, 120, 150), device=dev) * 255
    x, y, s, lv, ang, valid = _keypoints(dev, 6, 120, 150, 160, seed=3)
    valid = torch.arange(160, device=dev) < 150
    got = desc.descriptor_loop(blur, x, y, s, lv, ang, valid, 150, 50)
    ref = desc.descriptor_loop_torch(blur, x, y, s, lv, ang, valid, 150, 50)
    assert torch.all(got[150:] == 0) and _rel_rows(got, ref)


def _job_cases(dev, case, L, H, W, n):
    """Jobs that stress the tile boxes: keypoints within a pixel or two
    of every border, supports wider than the static window (sigma past
    the accept limit's 4.53), and angles at and next to the multiples of
    pi/4 where a box is tightest or widest."""
    x, y, s, lv, ang, _ = _keypoints(dev, L, H, W, n, seed=11)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    if case == "border":
        edge = np.array([0.2, 1.0, 1.6, 2.4])
        x[:16] = f(np.concatenate([edge, W - 1 - edge, np.full(8, W / 2)]))
        y[:16] = f(np.concatenate([np.full(8, H / 2), edge, H - 1 - edge]))
        x[16:20] = f([0.3, W - 1.2, 0.7, W - 1.4])
        y[16:20] = f([0.4, 0.6, H - 1.3, H - 1.1])
    elif case == "large_sigma":
        s = f(np.random.default_rng(12).uniform(4.4, 5.7, n))
    else:
        sweep = np.arange(-8, 9) * (math.pi / 8)
        ang[:51] = f(np.concatenate([sweep, sweep + 1e-4, sweep - 1e-4]))
    return x, y, s, lv, ang, torch.ones(n, dtype=torch.bool, device=dev)


@pytest.mark.parametrize("case", ["border", "large_sigma", "angles"])
def test_descriptor_kernel_cases(dev, case):
    """K4 against its plain version where a tile box that is too tight,
    or clipped wrongly, would lose weight."""
    L, H, W, n, radius = 6, 140, 170, 96, 51
    blur = torch.rand((L, H, W), device=dev) * 255
    x, y, s, lv, ang, valid = _job_cases(dev, case, L, H, W, n)
    got = desc.descriptor_loop(blur, x, y, s, lv, ang, valid, n, radius)
    ref = desc.descriptor_loop_torch(blur, x, y, s, lv, ang, valid, n,
                                     radius)
    assert ref.abs().sum() > 0 and _rel_rows(got, ref)


def test_descriptor_octaves_kernel(dev):
    """One launch over three octaves equals the three single-octave
    launches bit for bit, skips rows that are not valid, counts one
    launch, and gives the same bits twice."""
    radius = 51
    shapes = [(6, 140, 170, 96), (6, 70, 85, 40), (12, 35, 43, 24)]
    blurs, cols, singles, ends = [], [], [], []
    for i, (L, H, W, n) in enumerate(shapes):
        blur = torch.rand((L, H, W), device=dev) * 255
        x, y, s, lv, ang, valid = _keypoints(dev, L, H, W, n, seed=20 + i)
        s = s.clamp(max=0.04 * min(H, W) + 1.2)
        blurs.append(blur)
        cols.append((x, y, s, lv, ang, valid))
        singles.append(desc.descriptor_loop(blur, x, y, s, lv, ang, valid,
                                            n, radius))
        ends.append(n + (ends[-1] if ends else 0))
    args = [torch.cat([c[i] for c in cols]) for i in range(6)]
    b0, b1 = desc.launches_octaves, desc.launches
    got = desc.descriptor_loop_octaves(blurs, ends, *args, radius)
    assert (desc.launches_octaves, desc.launches) == (b0 + 1, b1)
    assert torch.equal(got, torch.cat(singles))
    assert torch.all(got[~args[5]] == 0) and got[args[5]].abs().sum() > 0
    again = desc.descriptor_loop_octaves(blurs, ends, *args, radius)
    assert torch.equal(got, again)
    ref = desc.descriptor_loop_octaves_torch(blurs, ends, *args, radius)
    assert _rel_rows(got, ref)


@pytest.mark.parametrize("shape", [(9, 15), (75, 131), (200, 260)])
@pytest.mark.parametrize("span", [0, 1, 5, 13, 24])
@pytest.mark.parametrize("with_pick", [False, True])
def test_blur_dog_kernel_spans(dev, shape, span, with_pick):
    """K5 equals its plain version bit for bit for every filter class
    (S <= 8, <= 16, <= 24), on planes smaller than a strip and than the
    filter, on strided planes of a [N, L, H, W] stack, and with the pick
    of every second pixel into a strided plane of another stack."""
    rng = np.random.default_rng(span)
    k = rng.random(2 * span + 1).astype(np.float32)
    k = (k + k[::-1]) / (2 * k.sum())
    gen = torch.Generator(device="cpu").manual_seed(span)
    stack = (torch.rand((2, 4, *shape), generator=gen) * 255).to(dev)
    oh, ow = (shape[0] + 1) // 2, (shape[1] + 1) // 2
    nxt = torch.full((2, 3, oh, ow), -1.0, device=dev)
    want = blur_dog.blur_dog_torch(stack[:, 1], k)
    got = blur_dog.blur_dog(stack[:, 1], k, out=(stack[:, 2], stack[:, 3]),
                            pick=nxt[:, 1] if with_pick else None)
    torch.cuda.synchronize(dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if with_pick:
        assert torch.equal(nxt[:, 1], want[0][:, 0::2, 0::2][:, :oh, :ow])
    assert torch.all(nxt[:, 0] == -1) and torch.all(nxt[:, 2] == -1)


@pytest.mark.parametrize("dims", [[(34, 60), (17, 30), (9, 15)],
                                  [(57, 71), (29, 36)], [(9, 15)]])
def test_blur_dog_thin_kernel(dev, dims):
    """K5's one launch over several thin octaves of three frames equals
    its plain version and the level-by-level launches bit for bit, the
    picks between octaves included; one launch is counted."""
    ks = _chain_kernels()
    L = len(ks) + 1
    gen = torch.Generator(device="cpu").manual_seed(dims[0][0])
    mk = lambda n, h, w: (torch.rand((3, n, h, w), generator=gen)
                          * 255).to(dev)
    blurs = [mk(L, h, w) for h, w in dims]
    dogs = [mk(L - 1, h, w) for h, w in dims]
    want_b = [b.clone() for b in blurs]
    want_d = [d.clone() for d in dogs]
    blur_dog.blur_dog_thin_torch(want_b, want_d, ks, L - 3)
    level_b = [b.clone() for b in blurs]
    level_d = [d.clone() for d in dogs]
    for o in range(len(dims)):
        nxt = level_b[o + 1][:, 0] if o + 1 < len(dims) else None
        for l, k in enumerate(ks, start=1):
            blur_dog.blur_dog(level_b[o][:, l - 1], k,
                              out=(level_b[o][:, l], level_d[o][:, l - 1]),
                              pick=nxt if l == L - 3 else None)
    before = (blur_dog.launches_thin, blur_dog.launches)
    blur_dog.blur_dog_thin(blurs, dogs, ks, L - 3)
    torch.cuda.synchronize(dev)
    assert (blur_dog.launches_thin, blur_dog.launches) == (before[0] + 1,
                                                           before[1])
    for o in range(len(dims)):
        assert torch.equal(blurs[o], want_b[o]), o
        assert torch.equal(dogs[o], want_d[o]), o
        assert torch.equal(blurs[o], level_b[o]), o
        assert torch.equal(dogs[o], level_d[o]), o
    with pytest.raises(ValueError, match="blur_dog_thin"):
        big = [torch.zeros((1, L, 135, 240), device=dev)]
        blur_dog.blur_dog_thin(big, [big[0][:, 1:].contiguous()], ks, L - 3)


@pytest.mark.parametrize("level", [1, 5])
def test_blur_dog_kernel(dev, level):
    """K5 on strided level planes of a [N, L, H, W] stack (the batched
    front's layout) equals its plain version bit for bit."""
    tables = build_gauss_tables(SiftConfig())
    k = full_kernel(tables.inc[level], int(tables.inc_span[level]))
    gen = torch.Generator(device="cpu").manual_seed(level)
    stack = (torch.rand((3, 4, 75, 131), generator=gen) * 255).to(dev)
    want = blur_dog.blur_dog_torch(stack[:, 1], k)
    before = blur_dog.launches
    got = blur_dog.blur_dog(stack[:, 1], k, out=(stack[:, 2], stack[:, 3]))
    torch.cuda.synchronize(dev)
    assert blur_dog.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_extrema_mask_batched_kernel(dev):
    dog = torch.cat([_dog(dev, seed=s) for s in (4, 5, 6)])
    before = extrema_mask.launches_batched
    got = extrema_mask.candidate_mask_batched(dog, 3, 2.72)
    assert extrema_mask.launches_batched == before + 1
    ref = extrema_mask.candidate_mask_batched_torch(dog, 3, 2.72)
    assert ref.sum() > 0 and torch.equal(got, ref)
    assert torch.equal(got[1], extrema_mask.candidate_mask(dog[5:10], 2.72))


@pytest.mark.parametrize("vlfeat", [False, True])
def test_refine_batched_kernel(dev, vlfeat):
    cfg = SiftConfig(sift_mode="vlfeat" if vlfeat else "popsift")
    dog = torch.cat([_dog(dev, seed=s) for s in (7, 8)])
    rset = extrema.collect_refined_batched(dog, 2, cfg, 512)
    assert int(rset.n_found.min()) > 0
    before = refine.launches_batched
    cap = 512
    rng = np.random.default_rng(0)
    z0 = torch.from_numpy(rng.integers(1, 5, 2 * cap)).to(dev)
    z0[::4] = 4                         # the frames' top DoG layer
    x0 = torch.from_numpy(rng.integers(4, 127, 2 * cap)).to(dev)
    y0 = torch.from_numpy(rng.integers(4, 93, 2 * cap)).to(dev)
    n_found = torch.tensor([cap, 300], device=dev)
    kw = dict(maxlevel=5, vlfeat=vlfeat)
    got = refine.refine_state_batched(dog, x0, y0, z0, n_found, 2, **kw)
    assert refine.launches_batched == before + 1
    ref = refine.refine_state_batched_torch(dog, x0, y0, z0, n_found, 2,
                                            **kw)
    assert torch.equal(got, ref)


def _centres(dev, K, H, W, seed):
    rng = np.random.default_rng(seed)
    cy, cx = rng.integers(0, H, K), rng.integers(0, W, K)
    cy[:4], cx[:4] = [0, H - 1, 0, H - 1], [0, W - 1, W - 1, 0]
    return (torch.from_numpy(cy).to(dev), torch.from_numpy(cx).to(dev))


@pytest.mark.parametrize("rows,cols,radius", [(11, 11, 5), (16, 128, 3)])
def test_window_kernel(dev, rows, cols, radius):
    """K6 equals its plain version bit for bit, border centres included;
    rows past the count (read on the device) are zeros."""
    vol = _dog(dev, seed=9)
    cy, cx = _centres(dev, 200, 97, 131, seed=1)
    n = torch.tensor(150, device=dev)
    before = window.launches
    got = window.extract_windows(vol, cy, cx, n, radius, rows, cols)
    assert window.launches == before + 1
    ref = window.extract_windows_torch(vol, cy, cx, n, radius, rows, cols)
    assert got.shape == (200, 5, rows, cols)
    assert torch.equal(got, ref) and torch.all(got[150:] == 0)
    assert got[:150].abs().sum() > 0


def test_window_batched_kernel(dev):
    """Frame f's rows read layers [f*D, f*D + D) only."""
    F, cap = 3, 64
    vol = torch.cat([_dog(dev, seed=s) for s in (4, 5, 6)])
    cy, cx = _centres(dev, F * cap, 97, 131, seed=2)
    n_found = torch.tensor([cap, 0, 17], device=dev)
    before = window.launches_batched
    got = window.extract_windows_batched(vol, cy, cx, n_found, F, 5, 11, 11)
    assert window.launches_batched == before + 1
    ref = window.extract_windows_batched_torch(vol, cy, cx, n_found, F, 5,
                                               11, 11)
    assert torch.equal(got, ref)
    one = window.extract_windows(vol[10:15], cy[2 * cap:], cx[2 * cap:],
                                 n_found[2], 5, 11, 11)
    assert torch.equal(got[2 * cap:], one)
    assert torch.all(got[cap:2 * cap] == 0)


def _chain_kernels():
    cfg = SiftConfig()
    tables = build_gauss_tables(cfg)
    return [full_kernel(tables.inc[l], int(tables.inc_span[l]))
            for l in range(1, cfg.total_levels)]


@pytest.mark.parametrize("shape", [(75, 131), (9, 15), (200, 260)])
@pytest.mark.parametrize("group", [None, 3, 2, 1])
def test_blur_chain_kernel(dev, shape, group):
    """K7 on strided level planes of a [N, L, H, W] stack equals the
    level-by-level plain version and K5 bit for bit, also where the image
    is smaller than the group's halo."""
    ks = _chain_kernels()
    n = len(ks)
    gen = torch.Generator(device="cpu").manual_seed(3)
    levels = (torch.rand((2, n + 1, *shape), generator=gen) * 255).to(dev)
    dog = torch.zeros((2, n, *shape), device=dev)
    want = blur_chain.blur_chain_torch(levels[:, 0].clone(), ks)
    before = blur_chain.launches
    blur_chain.blur_chain(levels[:, 0], ks, group,
                          out=(levels[:, 1:], dog))
    torch.cuda.synchronize(dev)
    assert blur_chain.launches == before + -(-n // (group or n))
    for l in range(n):
        assert torch.equal(levels[:, l + 1], want[0][:, l]), l
        assert torch.equal(dog[:, l], want[1][:, l]), l
    prev = levels[:, 0]
    for l, k in enumerate(ks):
        b, d = blur_dog.blur_dog(prev, k)
        assert torch.equal(b, levels[:, l + 1]) and torch.equal(d, dog[:, l])
        prev = b


@pytest.mark.parametrize("shape", [(75, 131), (540, 960), (1080, 1920)])
def test_blur_chain_pick_kernel(dev, shape):
    """K7's launch of the group that holds the picked level also writes
    every second pixel of it into strided planes, at every tile side the
    launch chooses (16 to 64), equal to the plain version's."""
    ks = _chain_kernels()
    gen = torch.Generator(device="cpu").manual_seed(7)
    src = (torch.rand((1, *shape), generator=gen) * 255).to(dev)
    oh, ow = (shape[0] + 1) // 2, (shape[1] + 1) // 2
    nxt = torch.full((1, 3, oh, ow), -1.0, device=dev)
    got = blur_chain.blur_chain(src, ks, 3, pick=nxt[:, 1], pick_level=2)
    want_pick = torch.full((1, oh, ow), -2.0, device=dev)
    want = blur_chain.blur_chain_torch(src, ks, pick=want_pick, pick_level=2)
    torch.cuda.synchronize(dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(nxt[:, 1], want_pick)
    assert bool((nxt[:, 0] == -1).all() and (nxt[:, 2] == -1).all())


def test_pyramid_chain_front_on_the_card(dev):
    plan = pyr.build_pyramid_plan(SiftConfig(), 120, 160)
    gen = torch.Generator(device="cpu").manual_seed(5)
    img = (torch.rand((2, 120, 160), generator=gen) * 255).to(
        torch.uint8).to(dev)
    lb, ld = pyr.build_pyramid_frames(img, plan)
    cb, cd = pyr.build_pyramid_frames(img, plan, front="chain")
    for a, b in zip(cb + cd, lb + ld):
        assert torch.equal(a, b)


def test_descriptor_patch_entry(dev):
    """The patch entry against its plain version, and against the stack
    entry on jobs whose support lies inside their window and the image."""
    L, H, W, F, radius = 6, 160, 200, 96, 51
    blur = torch.rand((L, H, W), device=dev) * 255
    rng = np.random.default_rng(4)
    f = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    x = f(rng.uniform(2, W - 3, F).astype(np.float32))
    y = f(rng.uniform(2, H - 3, F).astype(np.float32))
    s = f(rng.uniform(1.2, 4.4, F).astype(np.float32))
    lv = f(rng.integers(0, L, F))
    ang = f(rng.uniform(-math.pi, math.pi, F).astype(np.float32))
    valid = torch.arange(F, device=dev) < F - 3
    rows, cols = 104, 128
    p, y0, x0 = patches.extract_patches_rect(
        patches.pad_for_patches(blur, max(rows, cols)), lv,
        torch.round(y).long(), torch.round(x).long(), rows, cols, radius,
        radius)
    before = desc.launches_patches
    got = desc.descriptor_loop_patches(p, y0, x0, x, y, s, ang, valid, H, W)
    assert desc.launches_patches == before + 1
    ref = desc.descriptor_loop_patches_torch(p, y0, x0, x, y, s, ang, valid,
                                             H, W)
    assert torch.all(got[F - 3:] == 0) and _rel_rows(got, ref)
    stack = desc.descriptor_loop(blur, x, y, s, lv, ang, valid, F, radius)
    assert _rel_rows(got, stack)


def test_bucketed_launches(dev):
    """The bucketed launches of K3 and K4 against the single launch on
    the same rows and against their plain versions."""
    L, H, W, n = 6, 120, 150, 200
    blur = torch.rand((L, H, W), device=dev) * 255
    x, y, s, lv, ang, valid = _keypoints(dev, L, H, W, n, seed=6)
    split = 1.6 * 2.0 ** (2.5 / 3)
    b3, l3 = orient.launches_bucketed, orient.launches
    got = orient.orientation_hist_bucketed(blur, x, y, s, lv, valid, 23,
                                           split, 13)
    assert (orient.launches_bucketed, orient.launches) == (b3 + 1, l3 + 2)
    single = orient.orientation_hist(blur, x, y, s, lv, valid, n, 23)
    assert torch.equal(got, single)       # K3 walks each row's own window
    assert _rel_rows(got, orient.orientation_hist_bucketed(
        blur, x, y, s, lv, valid, 23, split, 13, plain=True))
    assert torch.all(got[~valid] == 0)

    b4, l4 = desc.launches_bucketed, desc.launches
    got = desc.descriptor_loop_bucketed(blur, x, y, s, lv, ang, valid, 51,
                                        split, 33)
    assert (desc.launches_bucketed, desc.launches) == (b4 + 1, l4 + 2)
    single = desc.descriptor_loop(blur, x, y, s, lv, ang, valid, n, 51)
    assert _rel_rows(got, single)
    assert _rel_rows(got, desc.descriptor_loop_bucketed(
        blur, x, y, s, lv, ang, valid, 51, split, 33, plain=True))
    assert torch.all(got[~valid] == 0)


def _masks(dev, F, shapes, density, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((F, *sh), dtype=np.float32)
                             < density).to(dev) for sh in shapes]


@pytest.mark.parametrize("F", [1, 4])
@pytest.mark.parametrize("case", ["plan", "saturated", "pinned"])
def test_compact_kernel(dev, F, case):
    """Masks of five octave sizes (the largest of the large-mask branch,
    three levels deep when saturated) in one call, every output equal to
    the plain version's; frames whose masks start at unaligned bytes."""
    shapes = [(3, 2160, 3840), (3, 135, 240), (3, 68, 120), (3, 17, 30),
              (3, 9, 15)]
    caps = {"plan": (8192, 4096, 2048, 512, 512),
            "saturated": (256, 64, 32, 16, 16),
            "pinned": (8192, 4096, 2048, 512, 512)}[case]
    pinned = 2 if case == "pinned" else 0
    masks = _masks(dev, F, shapes, 0.0004, seed=F)
    masks[2][:, 1, 30, :] = True             # 120 candidates in one row
    before = compact.launches
    got = compact.compact_octaves(masks, caps, pinned, F)
    torch.cuda.synchronize(dev)
    assert compact.launches == before + 1
    want = compact.compact_octaves_torch(masks, caps, pinned, F)
    for name, a, b in zip(("x0", "y0", "z0", "n_found", "n_dropped"), got,
                          want):
        assert torch.equal(a, b), name
    if case == "saturated":
        assert bool((got[3][:, 0] == caps[0]).all())   # octave 0 saturates
    else:
        assert int(got[4].sum()) > 0          # the clamp dropped some


@pytest.mark.parametrize("shape,cap", [((3, 600, 640), 4096),
                                       ((3, 540, 960), 8192)])
def test_compact_kernel_index_scratch_sizes(dev, shape, cap):
    """Capacities whose indices take 32 KB of dynamic shared memory (two
    levels of 4096, one of 8192): with the select's 16 KB of static
    shared memory the block passes the 48 KB default, which a launch must
    opt out of (a spatially sharded band's capacity is half the
    octave's)."""
    rng = np.random.default_rng(cap)
    masks = [torch.from_numpy(rng.random((1, *shape)) < 0.002).to(dev)]
    got = compact.compact_octaves(masks, (cap,))
    want = compact.compact_octaves_torch(masks, (cap,))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3][0, 0]) > 0


@pytest.mark.parametrize("F", [1, 4])
@pytest.mark.parametrize("vlfeat", [False, True])
def test_refine_octaves_kernel(dev, F, vlfeat):
    cfg = SiftConfig(sift_mode="vlfeat" if vlfeat else "popsift")
    shapes = [(97, 131), (49, 66), (25, 33)]
    caps = (512, 256, 64)
    dogs = [torch.cat([_dog(dev, H=h, W=w, seed=7 * f + o)
                       for f in range(F)]) for o, (h, w) in enumerate(shapes)]
    masks = extrema.candidate_masks(dogs, cfg, F)
    rows = extrema.compact_octaves(masks, cfg, caps, F)
    assert int(rows.n_found.min()) > 0
    before = refine.launches_octaves
    kw = dict(maxlevel=5, vlfeat=vlfeat)
    got = refine.refine_state_octaves(dogs, rows.x0, rows.y0, rows.z0,
                                      rows.n_found, caps, F, **kw)
    assert refine.launches_octaves == before + 1
    ref = refine.refine_state_octaves_torch(dogs, rows.x0, rows.y0, rows.z0,
                                            rows.n_found, caps, F, **kw)
    assert torch.equal(got, ref)


def test_extract_does_not_synchronize(dev):
    """``extract`` and ``extract_batch`` of frames already on the card
    queue all their work without one stream synchronisation."""
    from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                            extract_batch)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(
        (rng.random((2, 96, 128)) * 255).astype(np.uint8)).to(dev)
    plan = build_extract_plan(SiftConfig(octaves=3), 96, 128)
    want = extract(frames[0], plan, dev)              # builds, warms up
    batch = extract_batch(frames, plan, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        one = extract(frames[0], plan, dev)
        two = extract_batch(frames, plan, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(one, want):
        assert torch.equal(a, b)
    for a, b in zip(two, batch):
        assert torch.equal(a, b)


def test_kernels_launch_on_their_tensors_device():
    """Every wrapper launches under its tensors' device guard: the main
    path on the last card, while ``cuda:0`` is the current device, equals
    the same run on ``cuda:0`` and leaves the current device alone.
    Without the guard the C entries would launch on ``cuda:0`` with the
    other card's pointers."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch on a device other "
                    "than the current one")
    from popsift_tpu_torch.pipeline import build_extract_plan, extract_batch
    d0 = torch.device("cuda", 0)
    d1 = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(5)
    frames = (rng.random((2, 96, 128)) * 255).astype(np.uint8)
    plan = build_extract_plan(SiftConfig(octaves=3), 96, 128)
    torch.cuda.set_device(d0)
    want = extract_batch(frames, plan, d0)
    got = extract_batch(frames, plan, d1)
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0
    for a, b in zip(got, want):
        assert a.device == d1
        assert torch.equal(a.cpu(), b.cpu())


def _band(stack, r0, hb, halo):
    """Rows [r0 - halo, r0 + hb + halo) of a stack, edge rows replicated
    past it (what the halo exchange gives a band)."""
    rows = torch.arange(r0 - halo, r0 + hb + halo,
                        device=stack.device).clamp(0, stack.shape[1] - 1)
    return stack[:, rows].contiguous()


@pytest.mark.parametrize("band", [0, 1, 3])
def test_refine_octaves_bounded_kernel(dev, band):
    """K2 on a DoG band of 64 rows with a halo of 6 (the band's own rows
    detected), the band's global row offset and the octave's height,
    against its plain version; whole-frame bounds equal the unbounded
    launch."""
    cfg = SiftConfig()
    dog = _dog(dev, H=256, W=131, seed=4)
    hb, hd = 64, 6
    dband = _band(dog, band * hb, hb, hd)
    masks = extrema.band_masks(extrema.candidate_masks([dband], cfg),
                               [(hd, hd + hb)])
    rows = extrema.compact_octaves(masks, cfg, (512,))
    assert int(rows.n_found.min()) > 0
    kw = dict(maxlevel=5, vlfeat=False, y_offsets=[band * hb - hd],
              heights=[256])
    args = ([dband], rows.x0, rows.y0, rows.z0, rows.n_found, (512,))
    b0, b1 = refine.launches_octaves_bounded, refine.launches_octaves
    got = refine.refine_state_octaves(*args, **kw)
    assert (refine.launches_octaves_bounded,
            refine.launches_octaves) == (b0 + 1, b1)
    assert torch.equal(got, refine.refine_state_octaves_torch(*args, **kw))
    rows = extrema.compact_octaves(extrema.candidate_masks([dog], cfg), cfg,
                                   (2048,))
    args = ([dog], rows.x0, rows.y0, rows.z0, rows.n_found, (2048,))
    kw = dict(maxlevel=5, vlfeat=False)
    assert torch.equal(refine.refine_state_octaves(*args, **kw),
                       refine.refine_state_octaves(
                           *args, **kw, y_offsets=[0], heights=[256]))


@pytest.mark.parametrize("band", [0, 1, 3])
def test_orientation_and_descriptor_bounded_kernels(dev, band):
    """K3 and K4 on a blur band of 70 rows with a halo of 52, keypoints in
    global rows with the band's offset and the frame's scan rows, against
    their plain versions and against the whole frame's unbounded
    launches (rows within 1e-5 x the row's max); whole-frame bounds equal
    the unbounded launch bit for bit."""
    L, H, W, hb, hk, n = 6, 280, 170, 70, 52, 64
    blur = torch.rand((L, H, W), device=dev) * 255
    x, y, s, lv, ang, valid = _keypoints(dev, L, hb + 10, W, n,
                                         seed=40 + band)
    y = (y + band * hb - 5).clamp(0, H - 1)
    s = s.clamp(max=4.0)      # K4's support (at most 46 rows) in the halo
    bband = _band(blur, band * hb, hb, hk)
    off = dict(y_offsets=[band * hb - hk], y_bounds=[(1, H - 2)])
    b0, b1 = orient.launches_octaves_bounded, orient.launches_octaves
    got = orient.orientation_hist_octaves([bband], [n], x, y, s, lv, valid,
                                          23, **off)
    assert (orient.launches_octaves_bounded,
            orient.launches_octaves) == (b0 + 1, b1)
    assert _rel_rows(got, orient.orientation_hist_octaves_torch(
        [bband], [n], x, y, s, lv, valid, 23, **off))
    whole = orient.orientation_hist_octaves([blur], [n], x, y, s, lv, valid,
                                            23)
    assert _rel_rows(got, whole) and whole.abs().sum() > 0
    assert torch.equal(whole, orient.orientation_hist_octaves(
        [blur], [n], x, y, s, lv, valid, 23, y_offsets=[0],
        y_bounds=[(1, H - 2)]))
    b0, b1 = desc.launches_octaves_bounded, desc.launches_octaves
    got = desc.descriptor_loop_octaves([bband], [n], x, y, s, lv, ang, valid,
                                       51, **off)
    assert (desc.launches_octaves_bounded,
            desc.launches_octaves) == (b0 + 1, b1)
    assert _rel_rows(got, desc.descriptor_loop_octaves_torch(
        [bband], [n], x, y, s, lv, ang, valid, 51, **off))
    whole = desc.descriptor_loop_octaves([blur], [n], x, y, s, lv, ang,
                                         valid, 51)
    assert _rel_rows(got, whole) and whole.abs().sum() > 0
    assert torch.equal(whole, desc.descriptor_loop_octaves(
        [blur], [n], x, y, s, lv, ang, valid, 51, y_offsets=[0],
        y_bounds=[(1, H - 2)]))
