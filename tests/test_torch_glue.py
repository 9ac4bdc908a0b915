"""The host glue of the extraction paths against the JAX package, on the
CPU: the stages that keep their counts on the device.

* the refinement of all octaves and frames (``refine_octaves``, the plain
  version of K2's all-octave entry) on the compacted rows of
  ``compact_octaves``, through ``finalize_refined`` per (frame, octave),
  against JAX ``refine_candidates`` (XLA) and the fused Pallas kernel in
  interpret mode, with the tolerances of tests/test_pallas_refine.py:41-52
  (masks and counts exact, floats rtol 1e-6 / atol 2e-5, at most 2
  level/cell flips);
* the orientation tail without a sort: ties at the 4th/5th place keep the
  lower bins, as ``lax.top_k`` does (``orientations_from_histograms``);
* the one-pass job build over octave-major segments of several frames
  with their layer offsets (the batch path's), exact against JAX;
* ``extract`` of a tensor equals ``extract`` of the same numpy image, the
  plan's constants are made once, and a ``SiftJob`` made without a plan
  returns its features without a saturation check.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import descriptors as jdesc
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops import orientation as jori
from popsift_tpu.ops.pyramid import assemble_dog_canvas
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch import pipeline as tpipe
from popsift_tpu_torch.ops import descriptors as tdesc
from popsift_tpu_torch.ops import extrema as text
from popsift_tpu_torch.ops import orientation as tori
from test_torch_batch import _random_dog
from test_torch_extrema import _assert_extrema_close
from test_torch_pipeline import port_config

torch.set_num_threads(1)
DIMS = [(45, 61), (23, 31)]
CAPS = (128, 64)


def _octave_dogs(F):
    """Per octave the DoG stacks of F frames back to back, numpy."""
    return [np.concatenate([_random_dog(h, w, seed=5 * f + o + 3)
                            for f in range(F)])
            for o, (h, w) in enumerate(DIMS)]


@pytest.mark.parametrize("ref,mode", [("xla", "popsift"), ("xla", "vlfeat"),
                                      ("pallas", "popsift")])
def test_refine_octaves_matches_jax(ref, mode):
    F = 2
    cfg = SiftConfig(sift_mode=mode)
    pcfg = port_config(cfg)
    dogs = _octave_dogs(F)
    tdogs = [torch.from_numpy(d) for d in dogs]
    rows = text.compact_octaves(text.candidate_masks(tdogs, pcfg, F), pcfg,
                                CAPS, F)
    state = text.refine_octaves(tdogs, rows, pcfg, CAPS, F)
    Ktot = sum(CAPS)
    assert state.shape == (F * Ktot, 16)
    offs = np.concatenate([[0], np.cumsum(CAPS)])
    for f in range(F):
        for o, ((H, W), cap) in enumerate(zip(DIMS, CAPS)):
            dog = dogs[o][5 * f:5 * f + 5]
            if ref == "xla":
                jc = jext.collect_candidates(jnp.asarray(dog), cfg, cap)
                want = jext.refine_candidates(jc, cfg, W, H)
                n = int(jc.n_found)
            else:
                canvas = assemble_dog_canvas([jnp.asarray(d) for d in dog],
                                             H, W)
                rs = jext.collect_refined(cfg, cap, canvas, (H, W),
                                          interpret=True)
                want = jext.finalize_refined(rs.vals, rs.valid, cfg, W, H,
                                             rs.n_found, rs.n_dropped)
                n = int(rs.n_found)
            sl = slice(f * Ktot + offs[o], f * Ktot + offs[o + 1])
            assert int(rows.n_found[f, o]) == n > 0, (f, o)
            valid = torch.arange(cap) < rows.n_found[f, o]
            got = text.finalize_refined(state[sl], valid, pcfg, W, H,
                                        rows.n_found[f, o],
                                        rows.n_dropped[f, o])
            assert torch.all(state[sl][n:] == 0)
            assert int(got.count) > 0
            _assert_extrema_close(got, want)


@pytest.mark.parametrize("smoothing", ["vlfeat", "opencv"])
@pytest.mark.parametrize("period", [6, 12])
def test_orientation_tail_ties_at_the_fourth_place(period, smoothing):
    """36 / period identical peaks (a periodic histogram smooths to a
    periodic one, so the peaks tie bit for bit): the 4th and 5th place
    tie, and the four lower bins are taken, as ``lax.top_k`` takes them."""
    rng = np.random.default_rng(period)
    hist = np.zeros((3, 36), np.float32)
    pattern = np.zeros(period, np.float32)
    pattern[0], pattern[1], pattern[-1] = 6.0, 2.0, 1.0
    hist[0] = np.tile(pattern, 36 // period)
    hist[1] = np.roll(hist[0], 2)
    hist[2] = rng.random(36).astype(np.float32) * 5
    valid = torch.ones(3, dtype=torch.bool)
    got = tori.orientations_from_histograms(torch.from_numpy(hist), valid,
                                            smoothing=smoothing)
    want = jori.orientations_from_histograms(
        jnp.asarray(hist), jnp.ones(3, bool), smoothing=smoothing)
    assert np.array_equal(got.ori_valid.numpy(), np.asarray(want.ori_valid))
    assert np.array_equal(got.num_ori.numpy(), np.asarray(want.num_ori))
    np.testing.assert_allclose(got.ori.numpy(), np.asarray(want.ori),
                               rtol=0, atol=1e-5)
    n_peaks = 36 // period
    assert int(got.num_ori[0]) == min(4, n_peaks)
    assert bool((got.ori[0, 1:int(got.num_ori[0])]
                 > got.ori[0, :int(got.num_ori[0]) - 1]).all())


def test_job_build_over_frames_matches_jax():
    """Octave-major segments of three frames (not in row order), one
    overfull and one empty, with the frames' layer offsets."""
    rng = np.random.default_rng(4)
    F, caps, jcaps, L = 3, (40, 24), (50, 30), 6
    Ktot = sum(caps)
    N = F * Ktot
    ori_valid = rng.random((N, 4)) < 0.3
    ori_valid[Ktot + 40:Ktot + 64] = True          # frame 1 octave 1: full
    ori_valid[2 * Ktot:2 * Ktot + 40] = False      # frame 2 octave 0: empty
    x, y, sigma = (rng.random(N).astype(np.float32) * 50 for _ in range(3))
    level = rng.integers(0, 6, N).astype(np.int64)
    ori = (rng.random((N, 4)) * 6 - 3).astype(np.float32)
    offs = (0, caps[0])
    segs = tuple((f * Ktot + offs[o], caps[o], jcaps[o])
                 for o in range(2) for f in range(F))
    lev = tuple(f * L for o in range(2) for f in range(F))
    jj, jc = jdesc.make_descriptor_jobs_segmented(
        *(jnp.asarray(a) for a in (x, y, sigma, level.astype(np.int32), ori,
                                   ori_valid)), segs)
    tj, tc = tdesc.make_descriptor_jobs_segmented(
        *(torch.from_numpy(a) for a in (x, y, sigma, level, ori,
                                         ori_valid)), segs,
        level_offsets=lev)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert int(tj.count) == int(jj.count)
    assert int(tc[4]) == jcaps[1] and int(tc[2]) == 0
    want_level = np.asarray(jj.level) + np.repeat(lev, np.repeat(jcaps, F))
    assert np.array_equal(tj.level.numpy(), want_level)
    for f in ("x", "y", "sigma", "ang", "kp_index", "valid"):
        assert np.array_equal(getattr(tj, f).numpy(),
                              np.asarray(getattr(jj, f))), f


def test_extract_takes_a_tensor_and_keeps_its_constants():
    cfg = port_config(SiftConfig(octaves=3))
    img = synthetic_image(64, 80, seed=3)
    plan = tpipe.build_extract_plan(cfg, 64, 80)
    a = tpipe.extract(img, plan, "cpu")
    consts = dict(plan._constants)
    b = tpipe.extract(torch.from_numpy(img), plan, "cpu")
    assert int(a.n_keypoints) > 0
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
    assert list(plan._constants) == [(1, torch.device("cpu"))]
    assert plan._constants[(1, torch.device("cpu"))] is consts[
        (1, torch.device("cpu"))]


def test_job_without_a_plan_skips_the_saturation_check():
    cfg = port_config(SiftConfig(octaves=3, extrema_capacity=2))
    img = synthetic_image(64, 80, seed=3)
    raw = tpipe.extract(img, tpipe.build_extract_plan(cfg, 64, 80), "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        host = tapi.SiftJob(raw).get()
    assert host.getFeatureCount() >= 0
    with pytest.warns(RuntimeWarning, match="saturated"):
        tapi.SiftJob(raw, tpipe.build_extract_plan(cfg, 64, 80)).get()
