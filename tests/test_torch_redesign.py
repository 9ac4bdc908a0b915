"""The redesigned descriptor (K4) and blur + DoG (K5) entries on the CPU.

What the CUDA kernels cannot show here, their wrappers and plain versions
can: inputs come from numpy seeds, and each test states its tolerance.

* ``descriptor_loop_octaves`` (one call over the job rows of all octaves)
  equals the per-octave ``descriptor_loop`` calls bit for bit, for
  front-packed rows (a single frame) and for scattered valid rows (a
  batch); ``extract`` calls it once and no per-octave entry, and its
  features sit within the golden tolerances (tests/test_golden.py:21-24)
  of JAX ``PopSift``; ``extract_batch`` equals ``extract`` frame by frame,
  every field exact.
* ``blur_dog_torch`` with the ``pick`` output equals the slice
  ``[:, 0::2, 0::2][:, :oh, :ow]`` exactly, and the pyramid's level 0 of
  every octave past the first equals JAX ``build_pyramid``'s at atol 1e-4
  on the 0..255 scale (the pyramid's tolerance, XLA's fusion choices).
* the thin octaves (a plane of at most 4096 pixels) go through one ``blur_dog_thin`` call, whose plain version
  equals the level-by-level calls exactly.
* ``tile_boxes``, the numpy model of the boxes the kernel's tile warps
  walk, contains every pixel to which the plain version's terms give a
  non-zero tile weight: exact containment, over random angles and angles
  next to the multiples of pi/4, sigmas up to the accept limit and
  beyond, and keypoints at every border.
"""

import math

import jax
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.api import PopSift as JaxPopSift
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import pyramid as jpyr
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch import pipeline as tpipe
from popsift_tpu_torch.ops import descriptors as tdesc
from popsift_tpu_torch.ops import pyramid as tpyr
from popsift_tpu_torch.ops.kernels import blur_dog as K5
from popsift_tpu_torch.ops.kernels import desc as K4
from test_golden import _flatten_host, _load_cases
from test_torch_pipeline import (CASES, _assert_within_golden_tolerances,
                                 port_config)

torch.set_num_threads(1)
RADIUS = 51      # loop_patch_radius of the default config


def _octave_jobs(rng, L, H, W, n, n_valid, packed):
    """n job rows on an [L, H, W] stack, n_valid of them valid: the first
    ones (``packed``, a single frame's list) or scattered ones."""
    valid = np.zeros(n, bool)
    if packed:
        valid[:n_valid] = True
    else:
        valid[rng.choice(n, n_valid, replace=False)] = True
    t = torch.from_numpy
    return (t(rng.uniform(0, W - 1, n).astype(np.float32)),
            t(rng.uniform(0, H - 1, n).astype(np.float32)),
            t(rng.uniform(1.3, 0.03 * min(H, W) + 1.5, n).astype(np.float32)),
            t(rng.integers(0, L, n)),
            t(rng.uniform(-math.pi, math.pi, n).astype(np.float32)),
            t(valid))


@pytest.mark.parametrize("packed", [True, False])
def test_octaves_wrapper_equals_per_octave_calls(packed):
    rng = np.random.default_rng(5)
    shapes = [(6, 72, 90, 14, 9), (6, 36, 45, 10, 4), (12, 18, 23, 6, 0),
              (6, 9, 12, 5, 2)]
    blurs, cols, singles, ends = [], [], [], []
    for L, H, W, n, nv in shapes:
        blur = torch.from_numpy(rng.random((L, H, W)).astype(np.float32)
                                * 255)
        job = _octave_jobs(rng, L, H, W, n, nv, packed)
        if packed:
            one = K4.descriptor_loop(blur, *job, nv, RADIUS)
        else:       # the per-octave call on the gathered valid rows
            rows = job[5].nonzero().squeeze(1)
            one = torch.zeros((n, 128))
            if nv:
                one[rows] = K4.descriptor_loop(
                    blur, *(a[rows] for a in job), nv, RADIUS)
        blurs.append(blur)
        cols.append(job)
        singles.append(one)
        ends.append(n + (ends[-1] if ends else 0))
    args = [torch.cat([c[i] for c in cols]) for i in range(6)]
    got = K4.descriptor_loop_octaves(blurs, ends, *args, RADIUS)
    want = torch.cat(singles)
    assert want.abs().sum() > 0 and torch.equal(got, want)
    assert torch.all(got[~args[5]] == 0)
    assert K4.launches_octaves == 0     # the CPU runs the plain version


def test_octaves_wrapper_checks_its_rows():
    blur = torch.zeros((6, 8, 8))
    z = torch.zeros(4)
    args = (z, z, z, z.long(), z, z.bool())
    with pytest.raises(ValueError, match="row ends"):
        K4.descriptor_loop_octaves([blur, blur], [4], *args, RADIUS)
    with pytest.raises(ValueError, match="row ends"):
        K4.descriptor_loop_octaves([blur, blur], [3, 2], *args, RADIUS)
    with pytest.raises(ValueError, match="row ends"):
        K4.descriptor_loop_octaves([blur], [3], *args, RADIUS)
    out = K4.descriptor_loop_octaves([blur, blur], [1, 4], *args, RADIUS)
    assert out.shape == (4, 128) and not out.any()


@pytest.fixture
def descriptor_calls(monkeypatch):
    """Counts of the calls ``extract`` makes to the descriptor entries."""
    calls = {"octaves": 0, "single": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tdesc, "descriptor_loop_octaves",
                        counted("octaves", tdesc.descriptor_loop_octaves))
    monkeypatch.setattr(tdesc, "descriptor_loop",
                        counted("single", tdesc.descriptor_loop))
    return calls


@pytest.mark.parametrize("name", CASES)
def test_extract_through_one_descriptor_call_matches_jax(name,
                                                         descriptor_calls):
    img, cfg, _ = _load_cases()[name]
    port = tapi.PopSift(port_config(cfg), device="cpu").enqueue(img).get()
    assert descriptor_calls == {"octaves": 1, "single": 0}
    jax_host = JaxPopSift(cfg).enqueue(img).get()
    assert port.getFeatureCount() == jax_host.getFeatureCount() > 0
    assert port.getDescriptorCount() == jax_host.getDescriptorCount()
    _assert_within_golden_tolerances(_flatten_host(port),
                                     _flatten_host(jax_host))


def test_extract_batch_equals_extract(descriptor_calls):
    cfg = port_config(SiftConfig(octaves=3))
    frames = np.stack([synthetic_image(64, 80, seed=s) for s in (3, 4, 5)])
    plan = tpipe.build_extract_plan(cfg, 64, 80)
    batch = tpipe.extract_batch(frames, plan, "cpu")
    assert descriptor_calls == {"octaves": 1, "single": 0}
    for f, frame in enumerate(frames):
        one = tpipe.extract(frame, plan, "cpu")
        got = tpipe.frame_features(batch, f)
        assert int(one.n_descriptors) > 0
        for field, a, b in zip(one._fields, got, one):
            assert torch.equal(a, b), (f, field)


@pytest.mark.parametrize("shape", [(9, 15), (10, 14), (37, 52)])
def test_pick_output_equals_the_slice(shape):
    rng = np.random.default_rng(shape[0])
    k = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    src = torch.from_numpy(rng.random((2, *shape)).astype(np.float32) * 255)
    oh, ow = (shape[0] + 1) // 2, (shape[1] + 1) // 2
    nxt = torch.full((2, 3, oh, ow), -1.0)
    want_b, want_d = K5.blur_dog_torch(src, k)
    blur, dog = K5.blur_dog(src, k, pick=nxt[:, 1])
    assert torch.equal(blur, want_b) and torch.equal(dog, want_d)
    assert torch.equal(nxt[:, 1], want_b[:, 0::2, 0::2][:, :oh, :ow])
    assert torch.all(nxt[:, 0] == -1) and torch.all(nxt[:, 2] == -1)
    # a pick smaller than every second pixel takes the top-left part
    small = torch.empty((2, oh - 1, ow - 2))
    K5.blur_dog_torch(src, k, pick=small)
    assert torch.equal(small, want_b[:, 0::2, 0::2][:, :oh - 1, :ow - 2])


@pytest.mark.parametrize("h,w,octaves,seed", [(64, 80, 3, 3),
                                              (67, 93, 4, 7)])
def test_next_octave_level0_matches_jax(h, w, octaves, seed):
    cfg = SiftConfig(octaves=octaves)
    img = synthetic_image(h, w, seed=seed)
    jplan = jpyr.build_pyramid_plan(cfg, h, w)
    jb, _ = jax.jit(lambda x: jpyr.build_pyramid(x, jplan))(img)
    plan = tpyr.build_pyramid_plan(port_config(cfg), h, w)
    tb, _ = tpyr.build_pyramid(torch.from_numpy(img), plan)
    src = cfg.total_levels - 3
    for o in range(1, len(tb)):
        oh, ow = plan.dims[o]
        assert torch.equal(tb[o][0], tb[o - 1][src, 0::2, 0::2][:oh, :ow])
        np.testing.assert_allclose(tb[o][0].numpy(), np.asarray(jb[o][0]),
                                   rtol=0, atol=1e-4)
    # the chain front copies the slice; both fronts give the same planes
    cb, _ = tpyr.build_pyramid(torch.from_numpy(img), plan, front="chain")
    assert all(torch.equal(a, b) for a, b in zip(cb, tb))


def test_thin_octaves_take_one_call(monkeypatch):
    """Both fronts hand the octaves of at most 4096 pixels to one
    ``blur_dog_thin`` call, which on the CPU equals the level-by-level
    calls bit for bit."""
    cfg = port_config(SiftConfig())
    big = tpyr.build_pyramid_plan(cfg, 1080, 1920)
    assert tpyr.first_thin_octave(big) == 6 and big.dims[6] == (34, 60)
    plan = tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=4)),
                                   67, 93)
    first = tpyr.first_thin_octave(plan)
    assert plan.dims[first:] == ((34, 47), (17, 24)) and first == 2
    calls = []
    real = tpyr.blur_dog_thin

    def counted(blurs, *a):
        calls.append([tuple(b.shape[2:]) for b in blurs])
        return real(blurs, *a)

    monkeypatch.setattr(tpyr, "blur_dog_thin", counted)
    img = torch.from_numpy(synthetic_image(67, 93, seed=2))
    tb, td = tpyr.build_pyramid(img, plan)
    assert calls == [[(34, 47), (17, 24)]]
    L = cfg.total_levels
    for o in range(first, len(tb)):
        for l in range(1, L):
            b, d = K5.blur_dog_torch(tb[o][l - 1][None],
                                     plan.inc_kernels[l])
            assert torch.equal(tb[o][l], b[0]), (o, l)
            assert torch.equal(td[o][l - 1], d[0]), (o, l)
    pb, pd = tpyr.build_pyramid(img, plan, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(tb + td, pb + pd))
    cb, cd = tpyr.build_pyramid(img, plan, front="chain")
    assert calls == [[(34, 47), (17, 24)]] * 2
    assert all(torch.equal(a, b) for a, b in zip(cb + cd, tb + td))


def _weighted_pixels(x, y, sigma, ang, half):
    """bool[4, 4, P, P], (ty, tx) first: the pixels of the (2 half + 1)^2
    window around round(x, y) to which the plain version's terms
    (ops/kernels/desc.py::_loop_terms) give tile (ty, tx) a non-zero
    weight, and the window's pixel coordinates."""
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    ii = torch.arange(-half, half + 1)
    px = (int(round(float(x))) + ii)[None, :]
    py = (int(round(float(y))) + ii)[:, None]
    sbp = (t(sigma) * 3.0).abs()
    inv_sbp = torch.reciprocal(sbp)
    crsbp = torch.cos(t(ang)) * inv_sbp
    srsbp = torch.sin(t(ang)) * inv_sbp
    fdx = px.float() - t(x)
    fdy = py.float() - t(y)
    nxg = crsbp * fdx + srsbp * fdy
    nyg = crsbp * fdy - srsbp * fdx
    centers = torch.arange(4, dtype=torch.float32) - 1.5
    wx = (nxg[None] - centers[:, None, None]).abs() < 1.0     # [tx, P, P]
    wy = (nyg[None] - centers[:, None, None]).abs() < 1.0     # [ty, P, P]
    return wy[:, None] & wx[None, :], px, py


def _box_cases(case):
    rng = np.random.default_rng(8)
    n = 60
    x = rng.uniform(0, 200, n)
    y = rng.uniform(0, 150, n)
    sigma = rng.uniform(1.2, 4.53, n)      # up to the accept limit
    ang = rng.uniform(-math.pi, math.pi, n)
    if case == "angles":
        sweep = np.arange(-8, 9) * (math.pi / 8)
        ang = np.concatenate([sweep, sweep + 1e-4, sweep - 1e-4, ang[:9]])
    elif case == "borders":
        edge = np.array([0.0, 0.3, 0.5, 1.49, 1.5, 2.51])
        x[:24] = np.concatenate([edge, 199 - edge, np.full(12, 77.5)])
        y[:24] = np.concatenate([np.full(12, 40.5), edge, 149 - edge])
    elif case == "wide":
        sigma = rng.uniform(4.4, 6.5, n)   # supports past the static window
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(x), f32(y), f32(sigma), f32(ang)


@pytest.mark.parametrize("case", ["random", "angles", "borders", "wide"])
def test_tile_boxes_contain_every_weighted_pixel(case):
    x, y, sigma, ang = _box_cases(case)
    x_lo, x_hi, y_lo, y_hi = K4.tile_boxes(x, y, sigma, ang)
    assert x_lo.shape == (len(x), 4, 4)
    tightest = 0
    for k in range(len(x)):
        half = int(math.ceil(2.5 * math.sqrt(2.0) * 3.0 * sigma[k])) + 2
        w, px, py = _weighted_pixels(x[k], y[k], sigma[k], ang[k], half)
        assert w.any(dim=(2, 3)).all()       # every tile has some pixel
        pxb = px.expand(w.shape[2:]).numpy()
        pyb = py.expand(w.shape[2:]).numpy()
        for ty in range(4):
            for tx in range(4):
                m = w[ty, tx].numpy()
                assert pxb[m].min() >= x_lo[k, ty, tx], (k, ty, tx)
                assert pxb[m].max() <= x_hi[k, ty, tx], (k, ty, tx)
                assert pyb[m].min() >= y_lo[k, ty, tx], (k, ty, tx)
                assert pyb[m].max() <= y_hi[k, ty, tx], (k, ty, tx)
                tightest = max(tightest,
                               (x_hi[k, ty, tx] - x_lo[k, ty, tx] + 1)
                               * (y_hi[k, ty, tx] - y_lo[k, ty, tx] + 1)
                               / (3.0 * sigma[k]) ** 2)
    # the box is a gather, not a scan: about 8 SBP^2 pixels at the widest
    # angle, up to 16 with the margins at the smallest sigma, where the
    # support's bounding square is 50 SBP^2
    assert tightest < 20.0
