"""The JAX package's per-octave public names in popsift_tpu_torch, against
the JAX package on the CPU, on the golden scenes ``small_image`` (64 x 80,
3 octaves) and ``medium_image`` (120 x 160, 4 octaves) with the JAX
pyramid fed to both sides:

* ``ops/extrema.py::detect_extrema`` against JAX's (XLA), on whole
  octaves and on a row band with halo (``row_window``, ``y_offset``), and
  ``collect_refined`` against JAX's fused Pallas refinement in interpret
  mode on the halo-padded canvas of the same stack: masks and counts
  exact, floats at rtol 1e-6 / atol 2e-5, at most 2 flips in level/cell
  (tests/test_torch_extrema.py);
* ``ops/orientation.py::assign_orientations`` against JAX's (XLA), also
  with row bounds: ``ori_valid`` and ``num_ori`` exact, angles within
  1e-5 rad (tests/test_torch_orientation.py);
* ``ops/descriptors.py::make_descriptor_jobs`` and
  ``ops/patches.py::extract_patches``: exact;
* ``ops/pyramid.py::build_pyramid_octaves`` within 1e-4 of JAX's
  (tests/test_torch_pyramid.py) and bit-equal to ``build_pyramid``;
* the per-octave chain (detect, orient, jobs, descriptors) equals
  ``extract``'s rows of each octave bit for bit, and
  ``pipeline.make_extract_fn(plan, "cpu")(img)`` equals ``extract`` field
  for field;
* ``runtime.available()`` equals JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu import runtime as jruntime
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import descriptors as jdesc
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops import orientation as jori
from popsift_tpu.ops import patches as jpat
from popsift_tpu.ops import pyramid as jpyr
from popsift_tpu.ops.pyramid import assemble_dog_canvas
from popsift_tpu_torch import pipeline as tpipe
from popsift_tpu_torch import runtime as truntime
from popsift_tpu_torch.ops import descriptors as tdesc
from popsift_tpu_torch.ops import extrema as text
from popsift_tpu_torch.ops import orientation as tori
from popsift_tpu_torch.ops import patches as tpat
from popsift_tpu_torch.ops import pyramid as tpyr
from test_torch_extrema import _assert_extrema_close
from test_torch_pipeline import port_config

torch.set_num_threads(1)
# name -> (h, w, seed, octaves): tests/conftest.py's small and medium image
SCENES = {"small": (64, 80, 3, 3), "medium": (120, 160, 7, 4)}
CAP = 256           # candidates an octave
JOB_CAP = 384       # jobs an octave (at most 4 x CAP, see make_jobs)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(cfg, image, JAX plan, JAX blurs, JAX dogs) of a scene."""
    h, w, seed, octaves = SCENES[name]
    cfg = SiftConfig(octaves=octaves)
    img = synthetic_image(h, w, seed=seed)
    plan = jpyr.build_pyramid_plan(cfg, h, w)
    blurs, dogs = jax.jit(lambda x: jpyr.build_pyramid(x, plan))(img)
    return (cfg, img, plan, [np.array(b) for b in blurs],
            [np.array(d) for d in dogs])


@functools.lru_cache(maxsize=None)
def _jax_octaves(name):
    """Per octave JAX's (ext, oris) of the scene (jitted: eager XLA on
    the CPU takes seconds an octave)."""
    cfg, _, plan, blurs, dogs = _scene(name)
    out = []
    for o, (b, d) in enumerate(zip(blurs, dogs)):
        H, W = plan.dims[o]

        def one(b, d, H=H, W=W):
            ext = jext.detect_extrema(d, cfg, CAP, W, H)
            return ext, jori.assign_orientations(b, ext, cfg)
        out.append(jax.jit(one)(b, d))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_ext(e):
    return text.OctaveExtrema(*(_t(v) for v in e))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_detect_extrema_matches_jax(scene):
    cfg, _, plan, _, dogs = _scene(scene)
    pcfg = port_config(cfg)
    total = 0
    for o, (d, (want, _)) in enumerate(zip(dogs, _jax_octaves(scene))):
        H, W = plan.dims[o]
        got = text.detect_extrema(torch.from_numpy(d), pcfg, CAP, W, H)
        assert int(got.n_candidates) == int(want.n_candidates), o
        assert int(got.n_dropped) == int(want.n_dropped) == 0, o
        _assert_extrema_close(got, want)
        total += int(got.count)
    assert total > 3


@pytest.mark.parametrize("mode", ["popsift", "vlfeat"])
def test_detect_extrema_on_a_row_band_matches_jax(mode):
    """Octave 0 of the medium scene (240 x 320): the band of global rows
    [80, 160) with a halo of 8, local row 0 = global row 72."""
    cfg0, _, plan, _, dogs = _scene("medium")
    cfg = cfg0.replace(sift_mode=mode)
    H, W = plan.dims[0]
    band = dogs[0][:, 72:168]
    want = jax.jit(lambda d: jext.detect_extrema(
        d, cfg, CAP, W, H, row_window=(8, 88), y_offset=72))(band)
    got = text.detect_extrema(torch.from_numpy(np.ascontiguousarray(band)),
                              port_config(cfg), CAP, W, H,
                              row_window=(8, 88), y_offset=72)
    assert int(got.n_candidates) == int(want.n_candidates) > 0
    assert int(got.count) > 0
    _assert_extrema_close(got, want)
    y = got.y.numpy()[got.valid.numpy()]
    assert ((y >= 79.0) & (y <= 161.0)).all()        # global rows


def test_collect_refined_matches_jax_pallas_interpret():
    """Octave 1 of the small scene (64 x 80)."""
    octave = 1
    cfg, _, plan, _, dogs = _scene("small")
    H, W = plan.dims[octave]
    dog = dogs[octave]
    canvas = assemble_dog_canvas([jnp.asarray(d) for d in dog], H, W)
    rs = jext.collect_refined(cfg, CAP, canvas, (H, W), interpret=True)
    pcfg = port_config(cfg)
    got = text.collect_refined(pcfg, CAP, torch.from_numpy(dog), (H, W))
    n = int(rs.n_found)
    assert int(got.n_found) == n > 0
    assert int(got.n_dropped) == int(rs.n_dropped)
    assert np.array_equal(got.valid.numpy(), np.asarray(rs.valid))
    assert got.vals.shape == (CAP, 16)
    assert torch.all(got.vals[n:] == 0)
    want = jext.finalize_refined(rs.vals, rs.valid, cfg, W, H, rs.n_found,
                                 rs.n_dropped)
    _assert_extrema_close(text.finalize_refined(
        got.vals, got.valid, pcfg, W, H, got.n_found, got.n_dropped), want)
    with pytest.raises(ValueError):
        text.collect_refined(pcfg, CAP, torch.from_numpy(dog), (H, W + 1))


def _assert_oris_equal(got, want):
    assert np.array_equal(got.ori_valid.numpy(), np.asarray(want.ori_valid))
    assert np.array_equal(got.num_ori.numpy(), np.asarray(want.num_ori))
    np.testing.assert_allclose(got.ori.numpy(), np.asarray(want.ori),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_assign_orientations_matches_jax(scene):
    cfg, _, _, blurs, _ = _scene(scene)
    n = 0
    for b, (ext, want) in zip(blurs, _jax_octaves(scene)):
        got = tori.assign_orientations(torch.from_numpy(b), _port_ext(ext),
                                       port_config(cfg))
        _assert_oris_equal(got, want)
        n += int(got.num_ori.sum())
    assert n > 3


def test_assign_orientations_with_row_bounds_matches_jax():
    """Octave 0 of the medium scene with the scan rows cut to [40, 150]:
    keypoints near the cut lose pixels of their windows."""
    cfg, _, _, blurs, _ = _scene("medium")
    ext, full = _jax_octaves("medium")[0]
    b = jnp.asarray(blurs[0])
    want = jax.jit(lambda b, e: jori.assign_orientations(
        b, e, cfg, y_bounds=(40, 150)))(b, ext)
    got = tori.assign_orientations(torch.from_numpy(blurs[0]),
                                   _port_ext(ext), port_config(cfg),
                                   y_bounds=(40, 150))
    _assert_oris_equal(got, want)
    assert not np.array_equal(np.asarray(want.ori), np.asarray(full.ori))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_make_descriptor_jobs_matches_jax(scene):
    jobs_seen = 0
    for ext, oris in _jax_octaves(scene):
        want = jdesc.make_descriptor_jobs(ext, oris, JOB_CAP)
        got = tdesc.make_descriptor_jobs(
            _port_ext(ext), tori.OctaveOrientations(*(_t(v) for v in oris)),
            JOB_CAP)
        for name in want._fields:
            a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
        jobs_seen += int(got.count)
    assert jobs_seen > 3


def test_extract_patches_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.normal(size=(4, 30, 41)).astype(np.float32)
    K, radius = 64, 6
    level = rng.integers(-1, 6, K).astype(np.int32)
    cy = rng.integers(-8, 40, K).astype(np.int32)
    cx = rng.integers(-8, 50, K).astype(np.int32)
    want = jpat.extract_patches(jnp.asarray(img), jnp.asarray(level),
                                jnp.asarray(cy), jnp.asarray(cx), radius)
    got = tpat.extract_patches(torch.from_numpy(img), _t(level), _t(cy),
                               _t(cx), radius)
    assert got[0].shape == (K, 13, 13)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_pyramid_octaves_matches_jax(scene):
    cfg, img, jplan, _, _ = _scene(scene)
    plan = tpyr.build_pyramid_plan(port_config(cfg), *img.shape)
    t = torch.from_numpy(img)
    got = tpyr.build_pyramid_octaves(t, plan)
    want = jax.jit(lambda x: jpyr.build_pyramid_octaves(x, jplan))(img)
    blurs, dogs = tpyr.build_pyramid(t, plan)
    assert len(got) == len(want) == len(blurs)
    for (gl, gd), (wl, wd), b, d in zip(got, want, blurs, dogs):
        assert len(gl) == len(wl) == cfg.total_levels
        assert len(gd) == len(wd) == cfg.total_levels - 1
        for a, w in zip(gl + gd, list(wl) + list(wd)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)
        assert torch.equal(torch.stack(gl), b)
        assert torch.equal(torch.stack(gd), d)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_per_octave_chain_equals_extract(scene):
    """detect_extrema, assign_orientations, make_descriptor_jobs,
    compute_descriptors and normalize_descriptors on each octave of the
    port's own pyramid give ``extract``'s rows of that octave."""
    cfg, img, _, _, _ = _scene(scene)
    pcfg = port_config(cfg)
    plan = tpipe.build_extract_plan(pcfg, *img.shape)
    feats = tpipe.extract(img, plan, "cpu")
    blurs, dogs = tpyr.build_pyramid(torch.from_numpy(img), plan.pyramid)
    ko = np.concatenate([[0], np.cumsum(plan.ext_caps)])
    jo = np.concatenate([[0], np.cumsum(plan.job_caps)])
    n_kp = n_desc = 0
    for o, (b, d) in enumerate(zip(blurs, dogs)):
        H, W = plan.pyramid.dims[o]
        ext = tpipe.detect_extrema(d, pcfg, plan.ext_caps[o], W, H)
        oris = tpipe.assign_orientations(b, ext, pcfg)
        jobs = tpipe.make_descriptor_jobs(ext, oris, plan.job_caps[o])
        desc = tdesc.normalize_descriptors(
            tdesc.compute_descriptors(b, jobs, pcfg), pcfg)
        rows = slice(int(ko[o]), int(ko[o + 1]))
        scale = 2.0 ** (o - pcfg.upscale_factor)
        assert torch.equal(ext.valid, feats.valid[rows]), o
        for name in ("x", "y", "sigma"):
            assert torch.equal(getattr(ext, name) * scale,
                               getattr(feats, name)[rows]), (o, name)
        assert torch.equal(oris.ori, feats.ori[rows]), o
        assert torch.equal(oris.num_ori, feats.num_ori[rows]), o
        jrows = slice(int(jo[o]), int(jo[o + 1]))
        assert torch.equal(jobs.valid, feats.desc_valid[jrows]), o
        assert torch.equal(desc[jobs.valid],
                           feats.desc[jrows][feats.desc_valid[jrows]]), o
        n_kp += int(ext.count)
        n_desc += int(jobs.count)
    assert (n_kp, n_desc) == (int(feats.n_keypoints),
                              int(feats.n_descriptors))
    assert n_kp > 3


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_make_extract_fn_equals_extract(scene):
    cfg, img, _, _, _ = _scene(scene)
    plan = tpipe.build_extract_plan(port_config(cfg), *img.shape)
    got = tpipe.make_extract_fn(plan, "cpu")(img)
    want = tpipe.extract(img, plan, "cpu")
    for name, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


def test_runtime_available_matches_jax():
    assert truntime.available() == jruntime.available()
