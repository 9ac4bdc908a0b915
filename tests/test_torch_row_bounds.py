"""Row bounds of K2, K3 and K4 (a row band of ``parallel/spatial.py``):
the plain versions on bands of 112 rows cut with a halo from a 448-row
octave: the blur stack of octave 0 of a seeded 224 x 160 frame's pyramid
for K3 and K4, a seeded DoG stack dense in candidates for K2 (the frame's
octave 0 holds one); and the kernels' sources on the CPU
(``tools/host_mock.py``).

* K2 with a band's global row offset and the octave's height, then
  ``finalize_refined(y_offset=)``, against JAX's
  ``collect_candidates(row_window=)`` and ``refine_candidates(y_offset=)``
  on the same band (the tolerances of tests/test_torch_extrema.py), and
  bit-equal to the whole frame's detection of the band's rows;
  ``finalize_refined(y_offset=)`` on the same state against JAX's.
* K3 and K4 with local keypoint rows and local scan rows (offset 0, JAX's
  form) against ``_orientation_hist_xla(y_bounds=)`` and
  ``_descriptor_loop_chunk(y_bounds=)`` within 1e-5 x the row's max (the
  tolerance of tests/test_torch_orientation.py and
  test_torch_descriptors.py); with global keypoint rows and the band's
  offset against the whole frame's histograms and descriptors.
* The default bounds give the unbounded call bit for bit.
* ``sift_mode="opencv"``: its 5-pixel border falls on the band's local
  rows, as in JAX's sharded detection (so the top band keeps candidates
  in global rows 1-4 that the whole frame rejects; ROADMAP C).
* The CUDA sources with band bounds against the plain versions: K2 and
  the default tables bit-equal, K3 and K4 within 1e-5 x the row's max.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import descriptors as jdesc
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops import orientation as jori
from popsift_tpu.ops.patches import pad_for_patches
from popsift_tpu_torch.ops import extrema as text
from popsift_tpu_torch.ops.descriptors import loop_patch_radius
from popsift_tpu_torch.ops.kernels import build
from popsift_tpu_torch.ops.kernels import desc as K4
from popsift_tpu_torch.ops.kernels import orient as K3
from popsift_tpu_torch.ops.kernels import refine as K2
from popsift_tpu_torch.ops.orientation import max_ori_radius
from popsift_tpu_torch.ops.pyramid import build_pyramid, build_pyramid_plan
from popsift_tpu_torch.tools import host_mock
from test_torch_extrema import _assert_extrema_close, _random_dog
from test_torch_pipeline import port_config

torch.set_num_threads(1)

CFG = SiftConfig()
H, W = 224, 160
HB, HD, CAP = 112, 6, 512           # band rows, detection halo, capacity
BANDS = [0, 1, 3]                   # the top edge, an interior, the bottom


@pytest.fixture(scope="module")
def pyramid():
    """Octave 0's blur stack of the frame (port, plain) and a DoG stack
    of the same height (5 layers, 448 x 96, about 270 candidates a
    band)."""
    pcfg = port_config(CFG)
    plan = build_pyramid_plan(pcfg, H, W)
    img = torch.from_numpy(synthetic_image(H, W, seed=11))
    blurs, _ = build_pyramid(img, plan, plain=True)
    return blurs[0], torch.from_numpy(_random_dog(4 * HB, 96, seed=2,
                                                       scale=3.0))


def _band(stack: torch.Tensor, r0: int, halo: int) -> torch.Tensor:
    """Rows [r0 - halo, r0 + HB + halo) of a stack, edge rows replicated
    past the frame: what the halo exchange gives a band."""
    rows = torch.arange(r0 - halo, r0 + HB + halo).clamp(0,
                                                          stack.shape[1] - 1)
    return stack[:, rows].contiguous()


def _hk():
    pcfg = port_config(CFG)
    return max(max_ori_radius(pcfg) + 2, loop_patch_radius(pcfg) + 1)


def _band_detection(dband, goff, Hg):
    """The port's band form of detection on one octave's DoG band."""
    pcfg = port_config(CFG)
    masks = text.band_masks(text.candidate_masks([dband], pcfg),
                            [(HD, HD + HB)])
    rows = text.compact_octaves(masks, pcfg, (CAP,))
    state = text.refine_octaves([dband], rows, pcfg, (CAP,), y_offsets=[goff],
                                heights=[Hg])
    valid = torch.arange(CAP) < rows.n_found[0, 0]
    return rows, state, text.finalize_refined(
        state, valid, pcfg, dband.shape[2], Hg, rows.n_found[0, 0],
        rows.n_dropped[0, 0], y_offset=goff)


@pytest.mark.parametrize("b", BANDS)
def test_refine_band_matches_jax(pyramid, b):
    dog = pyramid[1]
    Hg, Wo = dog.shape[1:]
    r0, goff = b * HB, b * HB - HD
    dband = _band(dog, r0, HD)
    jc = jext.collect_candidates(jnp.asarray(dband.numpy()), CFG, CAP,
                                 row_window=(HD, HD + HB))
    ref = jext.refine_candidates(jc, CFG, Wo, Hg, y_offset=goff)
    rows, _, got = _band_detection(dband, goff, Hg)
    assert int(rows.n_found[0, 0]) == int(jc.n_found) > 0
    assert np.array_equal(rows.y0.numpy()[:int(jc.n_found)],
                          np.asarray(jc.y0)[:int(jc.n_found)])
    _assert_extrema_close(got, ref)


@pytest.mark.parametrize("b", BANDS)
def test_refine_band_equals_whole_frame(pyramid, b):
    """The band's refined rows are the whole frame's rows whose candidate
    lies in the band, bit for bit (the step policy's global row test)."""
    dog = pyramid[1]
    Hg, Wo = dog.shape[1:]
    r0 = b * HB
    rows, state, got = _band_detection(_band(dog, r0, HD), r0 - HD, Hg)
    pcfg = port_config(CFG)
    full = text.compact_octaves(text.candidate_masks([dog], pcfg), pcfg,
                                (4 * CAP,))
    fstate = text.refine_octaves([dog], full, pcfg, (4 * CAP,))
    n = int(full.n_found[0, 0])
    fvalid = torch.arange(4 * CAP) < n
    whole = text.finalize_refined(fstate, fvalid, pcfg, Wo, Hg, n, 0)
    mine = ((full.y0 >= r0) & (full.y0 < r0 + HB)).numpy()
    mine[n:] = False
    k = int(rows.n_found[0, 0])
    assert k == int(mine.sum()) > 0
    assert torch.equal(state[:k, 3:], fstate[mine][:, 3:])
    for f in ("x", "y", "s", "sigma", "valid", "level", "cell"):
        assert torch.equal(getattr(got, f)[:k], getattr(whole, f)[mine]), f


def test_opencv_border_on_a_band_matches_jax(pyramid):
    dog = pyramid[1]
    cfg = SiftConfig(sift_mode="opencv", upscale_factor=0)
    pcfg = port_config(cfg)
    dband = _band(dog, 0, HD)
    jc = jext.collect_candidates(jnp.asarray(dband.numpy()), cfg, CAP,
                                 row_window=(HD, HD + HB))
    masks = text.band_masks(text.candidate_masks([dband], pcfg),
                            [(HD, HD + HB)])
    rows = text.compact_octaves(masks, pcfg, (CAP,))
    n = int(jc.n_found)
    assert int(rows.n_found[0, 0]) == n > 0
    for a, b in ((rows.x0, jc.x0), (rows.y0, jc.y0), (rows.z0, jc.z0)):
        assert np.array_equal(a.numpy()[:n], np.asarray(b)[:n])
    whole = text.candidate_masks([dog], pcfg)[0][0]
    top = ((rows.y0[:n] >= HD) & (rows.y0[:n] < HD + 5)).sum()
    assert int(whole[:, :5].sum()) == 0 and int(top) > 0


def test_finalize_refined_offset_matches_jax(pyramid):
    dog = pyramid[1]
    Hg, Wo = dog.shape[1:]
    goff = HB - HD
    _, state, _ = _band_detection(_band(dog, HB, HD), goff, Hg)
    valid = (state[:, 6] != 0)
    pcfg = port_config(CFG)
    n = int(valid.sum())
    ref = jext.finalize_refined(jnp.asarray(state.numpy()),
                                jnp.asarray(valid.numpy()), CFG, Wo, Hg, n, 0,
                                y_offset=goff)
    for off in (goff, torch.full((CAP,), goff)):
        got = text.finalize_refined(state, valid, pcfg, Wo, Hg, n, 0,
                                    y_offset=off)
        _assert_extrema_close(got, ref)
        assert int(got.count) > 0


def test_refine_default_bounds_equal_unbounded(pyramid):
    dog = pyramid[1]
    pcfg = port_config(CFG)
    rows = text.compact_octaves(text.candidate_masks([dog], pcfg), pcfg,
                                (CAP,))
    plain = text.refine_octaves([dog], rows, pcfg, (CAP,))
    bounded = text.refine_octaves([dog], rows, pcfg, (CAP,), y_offsets=[0],
                                  heights=[dog.shape[1]])
    assert torch.equal(plain, bounded) and plain.abs().sum() > 0


def _keypoints(b, Hg, Wo, n=48, seed=0):
    """Keypoint rows of band ``b`` (global rows, some up to 5 rows past
    the band as refinement can move them), sigma up to the largest a
    level reaches."""
    rng = np.random.default_rng(seed + b)
    lo, hi = max(b * HB - 5, 0), min((b + 1) * HB + 5, Hg - 1)
    x = rng.uniform(0, Wo - 1, n).astype(np.float32)
    y = rng.uniform(lo, hi, n).astype(np.float32)
    x[:3] = [0.4, Wo - 1.3, Wo / 2]
    y[:2] = [lo + 0.2, hi - 0.4]
    s = rng.uniform(1.6, 4.5, n).astype(np.float32)
    lv = rng.integers(1, 4, n).astype(np.int64)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return [torch.from_numpy(a) for a in (x, y, s, lv, ang, valid)]


def _within(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    rowmax = np.abs(ref).max(1, keepdims=True)
    return bool(np.all(np.abs(got - ref) <= rel * rowmax + 1e-30))


def _jax_ext(x, y, s, lv, valid):
    z = jnp.zeros(x.shape[0], jnp.float32)
    return jext.OctaveExtrema(
        x=jnp.asarray(x.numpy()), y=jnp.asarray(y.numpy()), s=z,
        level=jnp.asarray(lv.numpy().astype(np.int32)),
        sigma=jnp.asarray(s.numpy()), cell=z.astype(jnp.int32),
        valid=jnp.asarray(valid.numpy()), count=jnp.int32(0),
        n_candidates=jnp.int32(0), n_dropped=jnp.int32(0))


@pytest.mark.parametrize("b", BANDS)
def test_orientation_band(pyramid, b):
    blur = pyramid[0]
    Hg, Wo = blur.shape[1:]
    hk = _hk()
    goff = b * HB - hk
    bband = _band(blur, b * HB, hk)
    x, y, s, lv, _, valid = _keypoints(b, Hg, Wo)
    n, R = x.shape[0], max_ori_radius(port_config(CFG))
    y_local = y - np.float32(goff)
    bounds = (1 - goff, Hg - 2 - goff)
    ref = jori._orientation_hist_xla(jnp.asarray(bband.numpy()),
                                     _jax_ext(x, y_local, s, lv, valid), CFG,
                                     R, y_bounds=bounds)
    got = K3.orientation_hist_torch(bband, x, y_local, s, lv, valid, n, R,
                                    y_bounds=bounds)
    ref = np.where(valid.numpy()[:, None], np.asarray(ref), 0.0)
    assert _within(got, ref) and np.abs(ref).sum() > 0
    # the keypoints in global rows with the band's offset: the whole
    # frame's histograms
    glob = K3.orientation_hist_torch(bband, x, y, s, lv, valid, n, R,
                                     y_off=goff, y_bounds=(1, Hg - 2))
    whole = K3.orientation_hist_torch(blur, x, y, s, lv, valid, n, R)
    assert _within(glob, whole)
    print(f"band {b}: K3 global form off the whole frame by "
          f"{float((glob - whole).abs().max()):.3g}")


@pytest.mark.parametrize("b", BANDS)
def test_descriptor_band(pyramid, b):
    blur = pyramid[0]
    Hg, Wo = blur.shape[1:]
    hk = _hk()
    goff = b * HB - hk
    bband = _band(blur, b * HB, hk)
    x, y, s, lv, ang, valid = _keypoints(b, Hg, Wo, seed=5)
    n, R = x.shape[0], loop_patch_radius(port_config(CFG))
    y_local = y - np.float32(goff)
    bounds = (1 - goff, Hg - 2 - goff)
    jobs = jdesc.DescriptorJobs(
        x=jnp.asarray(x.numpy()), y=jnp.asarray(y_local.numpy()),
        sigma=jnp.asarray(s.numpy()),
        level=jnp.asarray(lv.numpy().astype(np.int32)),
        ang=jnp.asarray(ang.numpy()), kp_index=jnp.zeros(n, jnp.int32),
        valid=jnp.asarray(valid.numpy()), count=jnp.int32(n))
    ref = jdesc._descriptor_loop_chunk(
        pad_for_patches(jnp.asarray(bband.numpy()), 2 * R + 1),
        bband.shape[1:], jobs, R, y_bounds=bounds)
    got = K4.descriptor_loop_torch(bband, x, y_local, s, lv, ang, valid, n,
                                   R, y_bounds=bounds)
    assert _within(got, np.asarray(ref)) and np.abs(np.asarray(ref)).sum() > 0
    glob = K4.descriptor_loop_torch(bband, x, y, s, lv, ang, valid, n, R,
                                    y_off=goff, y_bounds=(1, Hg - 2))
    whole = K4.descriptor_loop_torch(blur, x, y, s, lv, ang, valid, n, R)
    assert _within(glob, whole)
    print(f"band {b}: K4 global form off the whole frame by "
          f"{float((glob - whole).abs().max()):.3g}")


def test_orientation_and_descriptor_default_bounds(pyramid):
    blur = pyramid[0]
    Hg, Wo = blur.shape[1:]
    x, y, s, lv, ang, valid = _keypoints(1, Hg, Wo)
    n = x.shape[0]
    pcfg = port_config(CFG)
    R3, R4 = max_ori_radius(pcfg), loop_patch_radius(pcfg)
    a = K3.orientation_hist_octaves([blur], [n], x, y, s, lv, valid, R3)
    b = K3.orientation_hist_octaves([blur], [n], x, y, s, lv, valid, R3,
                                    y_offsets=[0], y_bounds=[(1, Hg - 2)])
    assert torch.equal(a, b) and a.abs().sum() > 0
    a = K4.descriptor_loop_octaves([blur], [n], x, y, s, lv, ang, valid, R4)
    b = K4.descriptor_loop_octaves([blur], [n], x, y, s, lv, ang, valid, R4,
                                   y_offsets=[0], y_bounds=[(1, Hg - 2)])
    assert torch.equal(a, b) and a.abs().sum() > 0
    with pytest.raises(ValueError):
        K4.descriptor_loop_octaves([blur], [n], x, y, s, lv, ang, valid, R4,
                                   y_bounds=[(1, Hg - 2), (1, 2)])
    with pytest.raises(ValueError):
        K2.refine_state_octaves([blur], torch.zeros(4, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32),
                                torch.zeros((1, 1), dtype=torch.int64), (4,),
                                maxlevel=5, vlfeat=False, y_offsets=[0])


def _library(name):
    if host_mock.find_compiler() is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = ctypes.CDLL(host_mock.build(name))
    for fn, args in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("b", BANDS)
def test_sources_with_band_bounds(pyramid, b):
    """K2, K3 and K4 compiled for the CPU on band ``b`` with its bounds,
    against their plain versions."""
    blur, dog = pyramid
    Hg, Wo = dog.shape[1:]
    pcfg = port_config(CFG)
    # K2 over the band's candidates
    r0 = b * HB
    dband = _band(dog, r0, HD)
    rows, want, _ = _band_detection(dband, r0 - HD, Hg)
    out = torch.full((CAP, 16), -1.0)
    table = np.asarray([[dband.data_ptr(), dband.shape[0], *dband.shape[1:],
                         CAP, r0 - HD, Hg]], np.int64)
    lib = _library("refine")
    assert lib.ps_refine_octaves(
        table.ctypes.data, 1, 1, rows.x0.data_ptr(), rows.y0.data_ptr(),
        rows.z0.data_ptr(), rows.n_found.data_ptr(), pcfg.total_levels - 1,
        0, out.data_ptr(), None) == 0
    assert torch.equal(out, want) and int(rows.n_found[0, 0]) > 0
    # K3 and K4 on the keypoint band, keypoints in global rows
    hk = _hk()
    goff = r0 - hk
    bband = _band(blur, r0, hk)
    x, y, s, lv, ang, valid = _keypoints(b, Hg, Wo, seed=9)
    n = x.shape[0]
    spec = [bband.data_ptr(), bband.shape[0], *bband.shape[1:], n, goff, 1,
            Hg - 2]
    hist = torch.full((n, 36), -1.0)
    t3 = np.asarray([spec], np.int64)
    assert _library("orient").ps_orientation_hist_octaves(
        t3.ctypes.data, 1, n, n, x.data_ptr(), y.data_ptr(), s.data_ptr(),
        lv.data_ptr(), valid.view(torch.uint8).data_ptr(), hist.data_ptr(),
        None) == 0
    ref = K3.orientation_hist_octaves([bband], [n], x, y, s, lv, valid,
                                      max_ori_radius(pcfg), y_offsets=[goff],
                                      y_bounds=[(1, Hg - 2)])
    assert _within(hist, ref) and ref.abs().sum() > 0
    desc = torch.zeros((n, 128))
    lv32, v8 = lv.to(torch.int32), valid.to(torch.uint8)
    R = loop_patch_radius(pcfg)
    assert _library("desc").ps_descriptor_loop_octaves(
        t3.ctypes.data, 1, x.data_ptr(), y.data_ptr(), s.data_ptr(),
        lv32.data_ptr(), ang.data_ptr(), v8.data_ptr(), R, desc.data_ptr(),
        None) == 0
    ref = K4.descriptor_loop_octaves([bband], [n], x, y, s, lv, ang, valid, R,
                                     y_offsets=[goff], y_bounds=[(1, Hg - 2)])
    assert _within(desc, ref) and ref.abs().sum() > 0
