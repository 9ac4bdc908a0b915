"""The port's launches over all octaves (K1 masks, K3 histograms) against
the JAX package on the CPU.

On the CPU the all-octave entries run their plain versions, which these
tests hold to the JAX functions as the JAX tests run them:

* masks of three octaves of F = 1 and F = 3 frames against JAX
  ``_candidate_mask(use_pallas=False)`` (the XLA mask) and against the
  Pallas kernel ``candidate_mask_pallas(..., interpret=True)``: exact,
  ``torch.bool``, equal to the port's per-octave entries, and the
  collections fed a ready mask equal those that make their own;
* histograms of three octaves of F = 1 and F = 3 frames against JAX
  ``_orientation_hist_xla`` per frame and octave within 1e-5 x the row's
  max (summation order differs), equal to the port's per-octave entry,
  rows that are not valid zero;
* ``extract`` and ``extract_batch`` through the new entries: the golden
  scenes within the golden tolerances (tests/test_golden.py:21-24) and
  every batched frame equal to its own ``extract``;
* ``_compact_mask`` on masks whose length is a multiple of 128 (taken as
  a view) against the same mask one element longer and against JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops import orientation as jori
from popsift_tpu.ops.pallas.extrema_mask import candidate_mask_pallas
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch import pipeline as tpipe
from popsift_tpu_torch.ops import extrema as text
from popsift_tpu_torch.ops import orientation as tori
from popsift_tpu_torch.ops.extrema import OctaveExtrema
from popsift_tpu_torch.ops.kernels import extrema_mask as K1
from popsift_tpu_torch.ops.kernels import orient as K3
from test_golden import GOLDEN_DIR, _flatten_host, _load_cases
from test_torch_batch import _random_dog
from test_torch_orientation import _assert_rows_close, _random_extrema
from test_torch_pipeline import _assert_within_golden_tolerances, port_config

torch.set_num_threads(1)
DIMS = [(64, 80), (32, 40), (16, 20)]


def _frames_dogs(F):
    """Per octave the DoG stacks of F frames back to back, numpy."""
    return [np.concatenate([_random_dog(h, w, seed=10 * f + o)
                            for f in range(F)])
            for o, (h, w) in enumerate(DIMS)]


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("mode", ["popsift", "opencv"])
def test_masks_of_all_octaves_match_jax(mode, F):
    cfg = SiftConfig(sift_mode=mode)
    pcfg = port_config(cfg)
    dogs = _frames_dogs(F)
    got = text.candidate_masks([torch.from_numpy(d) for d in dogs], pcfg, F)
    total = 0
    for o, (d, g) in enumerate(zip(dogs, got)):
        assert g.dtype == torch.bool and g.shape == (F, 3, *DIMS[o])
        for f in range(F):
            dog = d[5 * f:5 * f + 5]
            want = np.asarray(jext._candidate_mask(jnp.asarray(dog), cfg,
                                                   use_pallas=False))
            assert np.array_equal(g[f].numpy(), want), (o, f)
            one = text._candidate_mask(torch.from_numpy(dog), pcfg)
            assert torch.equal(g[f], one)
            total += int(want.sum())
    assert total > 30


@pytest.mark.parametrize("F", [1, 3])
def test_masks_of_all_octaves_match_pallas_interpret(F):
    thr1 = float(np.float32(text._first_threshold(port_config(SiftConfig()))))
    dogs = _frames_dogs(F)
    tdogs = [torch.from_numpy(d) for d in dogs]
    got = K1.candidate_mask_octaves(tdogs, thr1, F)
    for d, t, g in zip(dogs, tdogs, got):
        for f in range(F):
            want = np.asarray(candidate_mask_pallas(
                jnp.asarray(d[5 * f:5 * f + 5]), thr1, interpret=True))
            assert want.sum() > 0 and np.array_equal(g[f].numpy(), want)
        assert torch.equal(g.view(torch.uint8),
                           K1.candidate_mask_batched(t, F, thr1))
    with pytest.raises(ValueError, match="candidate_mask_octaves"):
        K1.candidate_mask_octaves([tdogs[0][:2]], thr1)
    with pytest.raises(ValueError, match="candidate_masks"):
        text.candidate_masks([tdogs[0][:4]], port_config(SiftConfig()))


@pytest.mark.parametrize("windows", [False, True])
def test_collections_take_a_ready_mask(windows):
    cfg = port_config(SiftConfig())
    F, cap = 3, 128
    dogs = [torch.from_numpy(d) for d in _frames_dogs(F)]
    masks = text.candidate_masks(dogs, cfg, F)
    for dog, mask in zip(dogs, masks):
        own = text.collect_candidates_batched(dog, F, cfg, cap,
                                              windows=windows)
        fed = text.collect_candidates_batched(dog, F, cfg, cap,
                                              windows=windows, mask=mask)
        one = text.collect_candidates(dog[5:10], cfg, cap, windows=windows,
                                      mask=mask[1])
        assert int(own.n_found.sum()) > 0
        for a, b in zip(own, fed):
            assert (a is None and b is None) or torch.equal(a, b)
        assert torch.equal(one.x0, fed.x0[cap:2 * cap])
        assert int(one.n_found) == int(fed.n_found[1])
    vals = text.collect_refined_batched(dogs[0], F, cfg, cap, mask=masks[0])
    assert torch.equal(vals.vals,
                       text.collect_refined_batched(dogs[0], F, cfg, cap).vals)


def _octave_rows(F, ns=(48, 24, 16)):
    """Blur stacks of three octaves for F frames and frame-major keypoint
    rows (each frame's octave segments back to back), with the JAX-shaped
    extrema of every (frame, octave) segment."""
    rng = np.random.default_rng(F)
    L = 6
    blurs = [(rng.random((F * L, h, w)) * 255).astype(np.float32)
             for h, w in DIMS]
    segs = [[_random_extrema(jnp.asarray(blurs[o][f * L:(f + 1) * L]), n,
                             seed=7 * f + o)
             for o, n in enumerate(ns)] for f in range(F)]
    flat = [e for frame in segs for e in frame]
    cat = lambda k: torch.from_numpy(np.concatenate(
        [np.asarray(getattr(e, k)) for e in flat]))
    ext = OctaveExtrema(x=cat("x"), y=cat("y"), s=cat("s"),
                        level=cat("level").long(), sigma=cat("sigma"),
                        cell=cat("cell").long(), valid=cat("valid"),
                        count=None, n_candidates=None, n_dropped=None)
    return blurs, segs, ext, np.cumsum(ns)


@pytest.mark.parametrize("F", [1, 3])
def test_histograms_of_all_octaves_match_xla(F):
    cfg = SiftConfig()
    pcfg = port_config(cfg)
    R = jori.max_ori_radius(cfg)
    blurs, segs, ext, ends = _octave_rows(F)
    tblurs = [torch.from_numpy(b) for b in blurs]
    got = tori.orientation_histograms_octaves(tblurs, ext, pcfg, ends, F)
    assert got.shape == (F * int(ends[-1]), 36)
    assert torch.all(got[~ext.valid] == 0) and got[ext.valid].sum() > 0
    k = 0
    for f in range(F):
        for o, e in enumerate(segs[f]):
            n = e.x.shape[0]
            blur = blurs[o][6 * f:6 * f + 6]
            want = np.asarray(jori._orientation_hist_xla(
                jnp.asarray(blur), e, cfg, R))
            _assert_rows_close(got[k:k + n].numpy(), want)
            sl = slice(k, k + n)
            one = tori.orientation_histograms(
                torch.from_numpy(blur),
                ext._replace(x=ext.x[sl], y=ext.y[sl], sigma=ext.sigma[sl],
                             level=ext.level[sl], valid=ext.valid[sl]),
                pcfg, n)
            assert torch.equal(got[sl], one), (f, o)
            k += n


def test_histograms_of_all_octaves_check_their_rows():
    blurs, _, ext, ends = _octave_rows(1)
    tblurs = [torch.from_numpy(b) for b in blurs]
    args = (ext.x, ext.y, ext.sigma, ext.level, ext.valid, 23)
    with pytest.raises(ValueError, match="row ends"):
        K3.orientation_hist_octaves(tblurs, ends[:2], *args)
    with pytest.raises(ValueError, match="row ends"):
        K3.orientation_hist_octaves(tblurs, ends, *args, F=3)
    # a level outside the frame's stack is clipped to it, not to the batch
    blurs2, _, ext2, ends2 = _octave_rows(2)
    t2 = [torch.from_numpy(b) for b in blurs2]
    hi = ext2._replace(level=ext2.level + 100)
    top = ext2._replace(level=torch.full_like(ext2.level, 5))
    cfg = port_config(SiftConfig())
    assert torch.equal(
        tori.orientation_histograms_octaves(t2, hi, cfg, ends2, 2),
        tori.orientation_histograms_octaves(t2, top, cfg, ends2, 2))


@pytest.fixture(scope="module")
def golden_runs():
    """``extract`` of both default golden scenes and ``extract_batch`` of
    each scene with two shifted copies, on the CPU."""
    out = {}
    for name in ("scene64_default", "scene120_default"):
        img, cfg, _ = _load_cases()[name]
        plan = tpipe.build_extract_plan(port_config(cfg), *img.shape)
        frames = np.stack([img, np.roll(img, 5, 1), np.roll(img, 9, 0)])
        out[name] = (plan, frames,
                     [tpipe.extract(f, plan, "cpu") for f in frames],
                     tpipe.extract_batch(frames, plan, "cpu"))
    return out


@pytest.mark.parametrize("name", ["scene64_default", "scene120_default"])
def test_extract_matches_golden(golden_runs, name):
    _, _, singles, batch = golden_runs[name]
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    for feats in (singles[0], tpipe.frame_features(batch, 0)):
        _assert_within_golden_tolerances(
            _flatten_host(tapi.FeaturesHost(feats)), want)


@pytest.mark.parametrize("f", range(3))
@pytest.mark.parametrize("name", ["scene64_default", "scene120_default"])
def test_extract_batch_equals_extract(golden_runs, name, f):
    _, _, singles, batch = golden_runs[name]
    one = tpipe.frame_features(batch, f)
    assert int(one.n_keypoints) > 0
    for a, b, field in zip(one, singles[f], one._fields):
        assert a.shape == b.shape and torch.equal(a, b), field


@pytest.mark.parametrize("n,cap", [(128 * 40, 64), (128 * 700, 96),
                                   (3 * 60 * 128, 256)])
def test_compact_mask_takes_aligned_masks_as_a_view(n, cap):
    """A mask whose length is a multiple of 128 is compacted without the
    padded copy: entry for entry as JAX (padding entries included), and
    its live entries and counts as the padded path gives them for the same
    mask with one false element appended."""
    rng = np.random.default_rng(n)
    m = rng.random(n) < 0.004
    m[1000:1030] = True
    want = jext._compact_mask(jnp.asarray(m), cap)
    got = text._compact_mask(torch.from_numpy(m), cap)
    padded = text._compact_mask(torch.from_numpy(np.append(m, False)), cap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    n = int(got[1])
    assert 0 < n == int(padded[1]) and int(got[2]) == int(padded[2])
    assert torch.equal(got[0][:n], padded[0][:n])
    # a strided mask is not viewed
    strided = torch.from_numpy(np.repeat(m, 2))[::2]
    for g, s in zip(got, text._compact_mask(strided, cap)):
        assert torch.equal(g, s)
