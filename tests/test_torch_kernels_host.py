"""The CUDA sources of K1-K5 and K7 on the CPU, against their plain
versions.

``popsift_tpu_torch/tools/host_mock.py`` compiles ``csrc/extrema_mask.cu``,
``csrc/refine.cu``, ``csrc/orient.cu``, ``csrc/desc.cu``,
``csrc/blur_dog.cu`` and ``csrc/blur_chain.cu`` with g++
against a stand-in for the CUDA runtime (one std::thread per CUDA thread)
and the tests call the C entry points on CPU tensors: the kernels' own
indexing, strips, tile boxes, rings, bands and summation order run here,
not a model of them. They need g++ and skip without it. Tolerances as on
the card: masks, refinement state, blur and DoG levels and the pick
bit-equal
(``-ffp-contract=off`` mirrors ``-fmad=false``), histograms and
descriptors within 1e-5 x the row's max of the plain version (another
summation order), a launch over several octaves bit-equal to the
single-octave launches.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from popsift_tpu_torch.ops import patches
from popsift_tpu_torch.ops.kernels import blur_chain as K7
from popsift_tpu_torch.ops.kernels import blur_dog as K5
from popsift_tpu_torch.ops.kernels import build
from popsift_tpu_torch.ops.kernels import desc as K4
from popsift_tpu_torch.ops.kernels import extrema_mask as K1
from popsift_tpu_torch.ops.kernels import orient as K3
from popsift_tpu_torch.ops.kernels import refine as K2
from popsift_tpu_torch.tools import host_mock

torch.set_num_threads(1)


def _library(name):
    if host_mock.find_compiler() is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = ctypes.CDLL(host_mock.build(name))
    for fn, args in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def blur_lib():
    return _library("blur_dog")


@pytest.fixture(scope="module")
def desc_lib():
    return _library("desc")


@pytest.mark.parametrize("shape", [(9, 15), (75, 131), (200, 260)])
@pytest.mark.parametrize("span", [0, 1, 5, 10, 13, 24])
def test_blur_dog_source(blur_lib, shape, span):
    """Strided planes, a plane smaller than the filter and the strip,
    several bands and strips, every shared-memory size class, the pick."""
    rng = np.random.default_rng(span + shape[0])
    k = rng.random(2 * span + 1).astype(np.float32)
    k = (k + k[::-1]) / (2 * k.sum())
    stack = torch.from_numpy(
        rng.random((2, 4, *shape)).astype(np.float32) * 255)
    src = stack[:, 1]
    want = K5.blur_dog_torch(src, k)
    oh, ow = (shape[0] + 1) // 2, (shape[1] + 1) // 2
    nxt = torch.full((2, 3, oh, ow), -1.0)
    taps = np.ascontiguousarray(k[span:])
    rc = blur_lib.ps_blur_dog(
        src.data_ptr(), src.stride(0), stack[:, 2].data_ptr(),
        stack.stride(0), stack[:, 3].data_ptr(), stack.stride(0),
        nxt[:, 1].data_ptr(), nxt.stride(0), oh, ow, 2, *shape,
        taps.ctypes.data, span, None)
    assert rc == 0
    assert torch.equal(stack[:, 2], want[0])
    assert torch.equal(stack[:, 3], want[1])
    assert torch.equal(nxt[:, 1], K5.pick_every_second(want[0], oh, ow))
    assert torch.all(nxt[:, 0] == -1) and torch.all(nxt[:, 2] == -1)


def test_blur_dog_source_refuses_a_wide_filter(blur_lib):
    z = torch.zeros((1, 4, 4))
    taps = np.zeros(26, np.float32)
    assert blur_lib.ps_blur_dog(
        z.data_ptr(), 16, z.data_ptr(), 16, z.data_ptr(), 16, None, 0, 0, 0,
        1, 4, 4, taps.ctypes.data, 25, None) != 0


@pytest.mark.parametrize("dims", [[(68, 120), (34, 60), (17, 30), (9, 15)],
                                  [(21, 33), (11, 17)], [(9, 15)]])
def test_blur_dog_thin_source(blur_lib, dims):
    """All levels of several thin octaves of two frames in one launch,
    picks between them included, bit-equal to the plain level blurs."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.gauss import build_gauss_tables, full_kernel
    cfg = SiftConfig()
    tables = build_gauss_tables(cfg)
    L = cfg.total_levels
    ks = [full_kernel(tables.inc[l], int(tables.inc_span[l]))
          for l in range(1, L)]
    rng = np.random.default_rng(dims[0][0])
    mk = lambda n, h, w: torch.from_numpy(
        rng.random((2, n, h, w)).astype(np.float32) * 255)
    blurs = [mk(L, h, w) for h, w in dims]
    dogs = [mk(L - 1, h, w) for h, w in dims]
    want_b = [b.clone() for b in blurs]
    want_d = [d.clone() for d in dogs]
    K5.blur_dog_thin_torch(want_b, want_d, ks, L - 3)
    table = np.asarray([[b.data_ptr(), d.data_ptr(), *b.shape[2:]]
                        for b, d in zip(blurs, dogs)], np.int64)
    spans = np.asarray([(k.shape[0] - 1) // 2 for k in ks], np.int32)
    taps = np.zeros((L - 1, K5.MAX_S + 1), np.float32)
    for row, k, S in zip(taps, ks, spans):
        row[:S + 1] = k[S:]
    rc = blur_lib.ps_blur_dog_thin(table.ctypes.data, len(dims), 2, L, L - 3,
                                   taps.ctypes.data, spans.ctypes.data, None)
    assert rc == 0
    for o in range(len(dims)):
        assert torch.equal(blurs[o], want_b[o]), o
        assert torch.equal(dogs[o], want_d[o]), o
    assert K5.thin_fits(9, 15, ks) and not K5.thin_fits(135, 240, ks)
    # a first plane beyond a third of the shared memory is refused
    table[0, 2:] = (135, 240)
    assert blur_lib.ps_blur_dog_thin(
        table.ctypes.data, 1, 2, L, L - 3, taps.ctypes.data,
        spans.ctypes.data, None) != 0


@pytest.fixture(scope="module")
def chain_lib():
    return _library("blur_chain")


def _chain_kernels(spans, seed):
    """Symmetric normalised filters of the given half-widths."""
    rng = np.random.default_rng(seed)
    out = []
    for S in spans:
        k = rng.random(2 * S + 1).astype(np.float32) + 0.1
        out.append((k + k[::-1]) / (2 * k.sum()))
    return out


def _chain_source(lib, src, ks, group, T, pick=None, pick_level=0):
    """The kernel source's levels of ``src`` f32[N, H, W], launched per
    group of levels as ops/kernels/blur_chain.py launches it, every
    output filled with junk first; tile side T (0: the launch's own)."""
    N, H, W = src.shape
    n = len(ks)
    blurs = torch.full((N, n, H, W), -3.0)
    dogs = torch.full((N, n, H, W), -3.0)
    spans = [(k.shape[0] - 1) // 2 for k in ks]
    oh, ow = (0, 0) if pick is None else pick.shape[-2:]
    prev = src
    for g0 in range(0, n, group):
        g1 = min(n, g0 + group)
        t = T or lib.ps_blur_chain_tile(N, H, W, sum(spans[g0:g1]))
        taps = np.ascontiguousarray(np.concatenate(
            [ks[i][spans[i]:] for i in range(g0, g1)]), dtype=np.float32)
        sp = np.asarray(spans[g0:g1], dtype=np.int32)
        b, d = blurs[:, g0:g1], dogs[:, g0:g1]
        pk = pick if pick is not None and g0 <= pick_level < g1 else None
        assert lib.ps_blur_chain(
            prev.data_ptr(), prev.stride(0), b.data_ptr(), b.stride(0),
            b.stride(1), d.data_ptr(), d.stride(0), d.stride(1),
            None if pk is None else pk.data_ptr(),
            0 if pk is None else pk.stride(0), oh, ow, pick_level - g0, N,
            H, W, taps.ctypes.data, sp.ctypes.data, g1 - g0, t, None) == 0
        prev = blurs[:, g1 - 1]
    return blurs, dogs


@pytest.mark.parametrize("shape,spans,group,T", [
    ((40, 56), (5, 7, 8, 10, 13), 3, 0),      # the default filters, 2 groups
    ((40, 56), (5, 7, 8, 10, 13), 5, 0),      # one group, halo 43
    ((75, 131), (0, 1, 2, 3, 4), 5, 0),       # narrow spans, one group
    ((75, 131), (13, 0, 6, 1), 2, 0),         # spans 0-13, two groups
    ((9, 15), (5, 7, 8, 10, 13), 3, 0),       # a plane smaller than a halo
    ((200, 260), (5, 7, 8), 3, 64),           # interior and edge tiles
    ((200, 260), (10, 13), 2, 32),
    ((75, 131), (5, 7, 8), 3, 24),            # a side that is no power of 2
    ((200, 260), (5, 7, 8, 10, 13), 5, 16),   # interior tiles, halo 43
])
def test_blur_chain_source(chain_lib, shape, spans, group, T):
    """The chain's levels and DoGs of two strided planes equal the plain
    level-by-level chain bit for bit, whatever the tile side and the
    grouping, with each level's own border replicated at every level."""
    ks = _chain_kernels(spans, sum(shape) + len(spans))
    rng = np.random.default_rng(shape[0])
    stack = torch.from_numpy(rng.random((2, 3, *shape)).astype(np.float32)
                             * 255)
    src = stack[:, 1]
    blurs, dogs = _chain_source(chain_lib, src, ks, group, T)
    want_b, want_d = K7.blur_chain_torch(src, ks)
    for l in range(len(ks)):
        assert torch.equal(blurs[:, l], want_b[:, l]), l
        assert torch.equal(dogs[:, l], want_d[:, l]), l


@pytest.mark.parametrize("shape,pick_level", [((75, 131), 2), ((40, 56), 0),
                                              ((9, 15), 2)])
def test_blur_chain_source_pick(chain_lib, shape, pick_level):
    """The launch of the group that holds level ``pick_level`` also writes
    every second pixel of it into strided planes, and nothing else."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.gauss import build_gauss_tables, full_kernel
    cfg = SiftConfig()
    tables = build_gauss_tables(cfg)
    ks = [full_kernel(tables.inc[l], int(tables.inc_span[l]))
          for l in range(1, cfg.total_levels)]
    rng = np.random.default_rng(shape[1])
    src = torch.from_numpy(rng.random((2, *shape)).astype(np.float32) * 255)
    oh, ow = (shape[0] + 1) // 2, (shape[1] + 1) // 2
    nxt = torch.full((2, 3, oh, ow), -1.0)
    blurs, _ = _chain_source(chain_lib, src, ks, 3, 0, pick=nxt[:, 1],
                             pick_level=pick_level)
    want = torch.full_like(nxt[:, 1], -1.0)
    K7.blur_chain_torch(src, ks, pick=want, pick_level=pick_level)
    assert torch.equal(nxt[:, 1], want)
    assert torch.equal(want, K5.pick_every_second(blurs[:, pick_level],
                                                  oh, ow))
    assert torch.all(nxt[:, 0] == -1) and torch.all(nxt[:, 2] == -1)


def test_blur_chain_source_refuses(chain_lib):
    """A halo whose two buffers overflow the shared memory, a span past
    24 and a pick level outside the group are refused."""
    z = torch.zeros((1, 4, 4))
    taps = np.zeros(5 * 25, np.float32)
    call = lambda spans, T, pick_level=-1, pick=None: chain_lib.ps_blur_chain(
        z.data_ptr(), 16, z.data_ptr(), 16, 16, z.data_ptr(), 16, 16, pick,
        4, 2, 2, pick_level, 1, 4, 4, taps.ctypes.data,
        np.asarray(spans, np.int32).ctypes.data, len(spans), T, None)
    assert chain_lib.ps_blur_chain_tile(1, 4, 4, 120) == 0
    assert call([24] * 5, 16) != 0
    assert call([25], 16) != 0
    assert call([3], 16, pick_level=1, pick=z.data_ptr()) != 0
    assert call([3], 16, pick_level=0, pick=z.data_ptr()) == 0
    assert call([3], 12) != 0                  # not a multiple of 8
    assert chain_lib.ps_blur_chain_tile(1, 2160, 3840, 20) == 64
    assert chain_lib.ps_blur_chain_tile(1, 2160, 3840, 23) == 56
    assert chain_lib.ps_blur_chain_tile(1, 540, 960, 20) == 40
    assert chain_lib.ps_blur_chain_tile(1, 270, 480, 20) == 16


def _jobs(rng, L, H, W, n, case):
    x = rng.uniform(0, W - 1, n).astype(np.float32)
    y = rng.uniform(0, H - 1, n).astype(np.float32)
    s = rng.uniform(1.2, 0.02 * min(H, W) + 1.6, n).astype(np.float32)
    ang = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    if case == "border":
        x[:8] = [0.2, W - 1.3, 1.0, W - 2.0, W / 2, W / 2, 3.3, W - 4.1]
        y[:8] = [0.4, H - 1.2, H / 2, H / 2, 1.0, H - 2.0, H - 3.7, 2.2]
    elif case == "angles":
        ang[:8] = [0, math.pi / 4, math.pi / 2, -math.pi / 4, 1e-4,
                   math.pi / 2 - 1e-4, math.pi, -math.pi / 2]
    elif case == "wide":            # supports past the static window
        s = rng.uniform(4.4, 5.7, n).astype(np.float32)
    valid = rng.random(n) < 0.85
    valid[:8] = True
    return [torch.from_numpy(a) for a in
            (x, y, s, rng.integers(0, L, n).astype(np.int32), ang, valid)]


def _single(lib, blur, x, y, s, lv, ang, valid, radius):
    out = torch.zeros((x.shape[0], 128))
    v8 = valid.to(torch.uint8)
    rc = lib.ps_descriptor_loop(
        blur.data_ptr(), *blur.shape, x.data_ptr(), y.data_ptr(),
        s.data_ptr(), lv.data_ptr(), ang.data_ptr(), v8.data_ptr(),
        x.shape[0], radius, out.data_ptr(), None)
    assert rc == 0
    return out


def _within(got, ref):
    rowmax = ref.abs().amax(1, keepdim=True)
    return bool(((got - ref).abs() <= 1e-5 * rowmax + 1e-30).all())


@pytest.mark.parametrize("case,shape", [
    ("border", (6, 120, 150)), ("angles", (6, 120, 150)),
    ("wide", (6, 140, 170)), ("border", (4, 30, 40))])
def test_descriptor_source(desc_lib, case, shape):
    rng = np.random.default_rng(len(case) + shape[1])
    blur = torch.from_numpy(rng.random(shape).astype(np.float32) * 255)
    job = _jobs(rng, *shape, 16, case)
    got = _single(desc_lib, blur, *job, 51)
    ref = K4.descriptor_loop_torch(blur, job[0], job[1], job[2],
                                   job[3].long(), job[4], job[5], 16, 51)
    assert ref.abs().sum() > 0 and _within(got, ref)
    assert torch.all(got[~job[5]] == 0)


def test_descriptor_source_over_octaves(desc_lib):
    rng = np.random.default_rng(3)
    sets, singles, table, end = [], [], [], 0
    for L, H, W, n in [(6, 96, 120, 12), (6, 48, 60, 9), (12, 24, 30, 8)]:
        blur = torch.from_numpy(rng.random((L, H, W)).astype(np.float32)
                                * 255)
        job = _jobs(rng, L, H, W, n, "border")
        sets.append((blur, job))
        singles.append(_single(desc_lib, blur, *job, 51))
        end += n
        table.append([blur.data_ptr(), L, H, W, end, 0, 1, H - 2])
    table = np.asarray(table, np.int64)
    cat = [torch.cat([j[i] for _, j in sets]).contiguous() for i in range(6)]
    v8 = cat[5].to(torch.uint8)
    out = torch.zeros((end, 128))
    rc = desc_lib.ps_descriptor_loop_octaves(
        table.ctypes.data, 3, cat[0].data_ptr(), cat[1].data_ptr(),
        cat[2].data_ptr(), cat[3].data_ptr(), cat[4].data_ptr(),
        v8.data_ptr(), 51, out.data_ptr(), None)
    assert rc == 0 and torch.equal(out, torch.cat(singles))
    ref = K4.descriptor_loop_octaves_torch(
        [b for b, _ in sets], [int(r[4]) for r in table], cat[0], cat[1],
        cat[2], cat[3].long(), cat[4], cat[5], 51)
    assert _within(out, ref)


def test_descriptor_source_patch_entry(desc_lib):
    rng = np.random.default_rng(4)
    L, H, W, n = 6, 120, 150, 12
    blur = torch.from_numpy(rng.random((L, H, W)).astype(np.float32) * 255)
    x, y, s, lv, ang, valid = _jobs(rng, L, H, W, n, "angles")
    x, y = x.clamp(2, W - 3), y.clamp(2, H - 3)
    p, y0, x0 = patches.extract_patches_rect(
        patches.pad_for_patches(blur, 128), lv.long(), torch.round(y).long(),
        torch.round(x).long(), 104, 128, 50, 50)
    p = p.contiguous()
    y0, x0 = y0.to(torch.int32), x0.to(torch.int32)
    v8 = valid.to(torch.uint8)
    out = torch.zeros((n, 128))
    rc = desc_lib.ps_descriptor_loop_patches(
        p.data_ptr(), 104, 128, H, W, y0.data_ptr(), x0.data_ptr(),
        x.data_ptr(), y.data_ptr(), s.data_ptr(), ang.data_ptr(),
        v8.data_ptr(), n, out.data_ptr(), None)
    ref = K4.descriptor_loop_patches_torch(p, y0, x0, x, y, s, ang, valid,
                                           H, W)
    assert rc == 0 and ref.abs().sum() > 0 and _within(out, ref)


@pytest.fixture(scope="module")
def mask_lib():
    return _library("extrema_mask")


@pytest.fixture(scope="module")
def orient_lib():
    return _library("orient")


def _dog_stack(rng, n, H, W):
    """Smooth f32[n, H, W] layers with plateaus (ties must stay false)
    and a lower half under the contrast gate (rows the kernel skips)."""
    d = rng.normal(size=(n, H, W)).astype(np.float32)
    d = (d + np.roll(d, 1, 1) + np.roll(d, 1, 2)) * 20
    d[:, : H // 3, : W // 3] = np.round(d[:, : H // 3, : W // 3] / 16) * 16
    d[:, H // 2 + 1:] *= 0.01
    return torch.from_numpy(d)


def _masks(lib, dogs, F, thr1):
    outs = [torch.full((F, d.shape[0] // F - 2, *d.shape[1:]), 7,
                       dtype=torch.uint8) for d in dogs]
    table = np.asarray([[d.data_ptr(), o.data_ptr(), d.shape[0] // F,
                         *d.shape[1:]] for d, o in zip(dogs, outs)], np.int64)
    assert lib.ps_extrema_mask_octaves(table.ctypes.data, len(dogs), F, thr1,
                                       None) == 0
    return outs


@pytest.mark.parametrize("D,H,W,F", [
    (5, 37, 52, 1),      # vector loads, five bands, one strip
    (5, 35, 131, 1),     # odd width: scalar loads, two strips
    (5, 70, 244, 2),     # three strips, nine bands, two frames
    (3, 9, 15, 1), (4, 9, 16, 2), (7, 12, 20, 1), (9, 6, 8, 1),
    (5, 1, 9, 1), (5, 2, 2, 1), (5, 1, 1, 2), (5, 3, 3, 1)])
def test_extrema_mask_source(mask_lib, D, H, W, F):
    """Strips, bands and layer groups, planes of one and two pixels, odd
    widths, frames that must not see each other's layers."""
    rng = np.random.default_rng(D * H + W)
    dog = _dog_stack(rng, F * D, H, W)
    got = _masks(mask_lib, [dog], F, 2.5)[0]
    ref = K1.candidate_mask_batched_torch(dog, F, 2.5)
    assert torch.equal(got, ref)
    if H > 8 and W > 8:
        assert ref.sum() > 0


def test_extrema_mask_source_over_octaves(mask_lib):
    """One launch over four octaves of two frames equals the launches of
    each octave alone, and an unaligned stack takes the scalar path."""
    rng = np.random.default_rng(8)
    dims = [(40, 124), (20, 62), (10, 31), (5, 16)]
    dogs = [_dog_stack(rng, 10, h, w) for h, w in dims]
    shifted = torch.zeros(10 * 40 * 124 + 1)
    shifted[1:] = dogs[0].reshape(-1)
    dogs[0] = shifted[1:].view(10, 40, 124)       # 4 bytes off alignment
    got = _masks(mask_lib, dogs, 2, 2.5)
    for d, g in zip(dogs, got):
        assert torch.equal(g, K1.candidate_mask_batched_torch(d, 2, 2.5))
        assert torch.equal(g, _masks(mask_lib, [d], 2, 2.5)[0])
    assert mask_lib.ps_extrema_mask_octaves(None, 0, 1, 2.5, None) != 0


def _keypoint_rows(rng, L, H, W, n, p_valid=0.8):
    x = rng.uniform(0, W - 1, n).astype(np.float32)
    y = rng.uniform(0, H - 1, n).astype(np.float32)
    x[:6] = [0.2, W - 1.2, W / 2, W / 2, 1.0, W - 2.0]     # at the edges
    y[:6] = [H / 2, H / 2, 0.3, H - 1.1, 1.0, H - 2.0]
    s = rng.uniform(1.6, max(2.0, min(5.1, 0.1 * min(H, W))), n).astype(
        np.float32)
    lv = rng.integers(-1, L + 1, n).astype(np.int64)         # clipped
    valid = rng.random(n) < p_valid
    return [torch.from_numpy(a) for a in (x, y, s, lv, valid)]


def _hists(lib, blurs, row_ends, x, y, s, lv, valid, F):
    out = torch.full((x.shape[0], 36), -1.0)
    table = np.asarray([[b.data_ptr(), b.shape[0] // F, *b.shape[1:], e, 0,
                         1, b.shape[1] - 2] for b, e in zip(blurs, row_ends)],
                       np.int64)
    assert lib.ps_orientation_hist_octaves(
        table.ctypes.data, len(blurs), x.shape[0], x.shape[0] // F,
        x.data_ptr(), y.data_ptr(), s.data_ptr(), lv.data_ptr(),
        valid.view(torch.uint8).data_ptr(), out.data_ptr(), None) == 0
    return out


@pytest.mark.parametrize("shape,n", [((6, 60, 80), 40), ((4, 20, 24), 12),
                                     ((3, 5, 4), 8)])
def test_orientation_source(orient_lib, shape, n):
    """Keypoints at the image edge, windows wider than the image, levels
    past the stack (clipped), invalid rows written as zeros."""
    rng = np.random.default_rng(shape[1])
    blur = torch.from_numpy(rng.random(shape).astype(np.float32) * 255)
    x, y, s, lv, valid = _keypoint_rows(rng, *shape, n)
    got = _hists(orient_lib, [blur], [n], x, y, s, lv, valid, 1)
    ref = K3.orientation_hist_torch(blur, x, y, s, lv, valid, n, 23)
    assert _within(got, ref) and torch.all(got[~valid] == 0)
    assert shape[1] < 10 or ref.abs().sum() > 0
    assert torch.equal(got, _hists(orient_lib, [blur], [n], x, y, s, lv,
                                   valid, 1))


def test_orientation_source_over_octaves(orient_lib):
    """Two frames x three octaves in one launch (the middle octave all
    invalid) against the plain version and, bit for bit, against
    single-octave launches on each frame's own layers."""
    rng = np.random.default_rng(5)
    F, shapes, ns = 2, [(6, 60, 80), (6, 30, 40), (6, 15, 20)], [14, 9, 8]
    blurs = [torch.from_numpy(rng.random((F * L, H, W)).astype(np.float32)
                              * 255) for L, H, W in shapes]
    ends = np.cumsum(ns).tolist()
    cols = [[] for _ in range(5)]
    for f in range(F):
        for o, (shape, n) in enumerate(zip(shapes, ns)):
            rows = _keypoint_rows(rng, *shape, n, 0.0 if o == 1 else 0.8)
            for c, r in zip(cols, rows):
                c.append(r)
    x, y, s, lv, valid = (torch.cat(c).contiguous() for c in cols)
    got = _hists(orient_lib, blurs, ends, x, y, s, lv, valid, F)
    ref = K3.orientation_hist_octaves_torch(blurs, ends, x, y, s, lv, valid,
                                            23, F)
    assert ref.abs().sum() > 0 and _within(got, ref)
    assert torch.all(got[~valid] == 0)
    k = 0
    for f in range(F):
        for o, ((L, H, W), n) in enumerate(zip(shapes, ns)):
            sl = slice(k, k + n)
            one = _hists(orient_lib, [blurs[o][f * L:(f + 1) * L]], [n],
                         x[sl].contiguous(), y[sl].contiguous(),
                         s[sl].contiguous(), lv[sl].contiguous(),
                         valid[sl].contiguous(), 1)
            assert torch.equal(got[sl], one), (f, o)
            k += n
    assert orient_lib.ps_orientation_hist_octaves(
        None, 3, 10, 3, None, None, None, None, None, None, None) != 0


@pytest.fixture(scope="module")
def refine_lib():
    return _library("refine")


@pytest.mark.parametrize("vlfeat", [False, True])
@pytest.mark.parametrize("F", [1, 3])
def test_refine_octaves_source(refine_lib, F, vlfeat):
    """K2's one launch over the rows of three octaves of F frames (rows on
    the image border and on a frame's top layer, an octave with no live
    row) equals ``refine_state_torch`` on each frame's octave, bit for
    bit, and writes zeros past every count."""
    rng = np.random.default_rng(F + 2 * vlfeat)
    D, dims, caps = 5, [(40, 56), (20, 28), (10, 14)], (48, 24, 8)
    dogs = [_dog_stack(rng, F * D, h, w) for h, w in dims]
    Ktot = sum(caps)
    cols = [[], [], []]
    for f in range(F):
        for (h, w), cap in zip(dims, caps):
            cols[0].append(rng.integers(0, w, cap))
            cols[1].append(rng.integers(0, h, cap))
            cols[2].append(rng.integers(1, D - 1, cap))
    x0, y0, z0 = (torch.from_numpy(np.concatenate(c).astype(np.int32))
                  for c in cols)
    z0[::5] = D - 2
    n_found = torch.from_numpy(rng.integers(1, np.asarray(caps) + 1,
                                            (F, 3)))
    n_found[0, 2] = 0
    out = torch.full((F * Ktot, 16), -1.0)
    table = np.asarray([[d.data_ptr(), D, *d.shape[1:], e, 0, d.shape[1]]
                        for d, e in zip(dogs, np.cumsum(caps))], np.int64)
    assert refine_lib.ps_refine_octaves(
        table.ctypes.data, 3, F, x0.data_ptr(), y0.data_ptr(), z0.data_ptr(),
        n_found.data_ptr(), D, int(vlfeat), out.data_ptr(), None) == 0
    offs = np.concatenate([[0], np.cumsum(caps)])
    for f in range(F):
        for o, dog in enumerate(dogs):
            rows = slice(f * Ktot + offs[o], f * Ktot + offs[o + 1])
            want = K2.refine_state_torch(
                dog[f * D:(f + 1) * D], x0[rows], y0[rows], z0[rows],
                int(n_found[f, o]), maxlevel=D, vlfeat=vlfeat)
            assert torch.equal(out[rows], want), (f, o)
    assert torch.equal(out, K2.refine_state_octaves(
        dogs, x0, y0, z0, n_found, caps, F, maxlevel=D, vlfeat=vlfeat))
    assert int((out != 0).any(1).sum()) > F * 20
    assert refine_lib.ps_refine_octaves(table.ctypes.data, 0, F, None, None,
                                        None, None, D, 0, None, None) != 0
