"""The extraction variants of popsift_tpu_torch against the JAX package
and the oracle on the CPU.

* Pyramids of every Gauss mode, both downscale modes, direct scaling,
  ``upscale_factor=0`` and ``sift_mode="opencv"`` against JAX
  ``build_pyramid``, within 1e-4 on the 0..255 scale (the default path's
  CPU gap, XLA's contractions against one rounding per op, is 4.6e-5).
* Each descriptor variant against JAX ``compute_descriptors`` on the same
  jobs, within 1e-5 x the row's max.
* K5's thin entry runs only for the incremental pick-every-second
  strategy; the chain front gives the level front's planes.
* The pyramid and descriptor cases of tests/test_variants.py, run through
  the port and held to the oracle there (the end-to-end cases are in
  tests/test_torch_variants_e2e.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import descriptors as jdesc
from popsift_tpu.ops import pyramid as jpyr
from popsift_tpu.oracle.sift_oracle import (oracle_descriptor_grid,
                                            oracle_descriptor_iloop,
                                            oracle_descriptor_tilegrid,
                                            oracle_pyramid)
from popsift_tpu_torch.config import SiftConfig as PortSiftConfig
from popsift_tpu_torch.ops import descriptors as tdesc
from popsift_tpu_torch.ops import pyramid as tpyr
from popsift_tpu_torch.ops.kernels import blur_dog as k5
from test_torch_pipeline import port_config
from test_variants import _sample_jobs

torch.set_num_threads(1)
PYR_TOL = 1e-4          # 0..255 scale
DESC_REL_TOL = 1e-5     # x the row's max
STRATEGIES = {
    "fixed9": dict(gauss_mode="fixed9"),
    "fixed15": dict(gauss_mode="fixed15"),
    "relative_all": dict(gauss_mode="vlfeat-relative-all",
                         sift_mode="vlfeat"),
    "relative": dict(gauss_mode="vlfeat-relative"),
    "gauss_opencv": dict(gauss_mode="opencv"),
    "interpolate": dict(downscale_mode="interpolate"),
    "direct": dict(scaling_mode="direct"),
    "upscale0": dict(upscale_factor=0.0),
    "sift_opencv": dict(sift_mode="opencv"),
    "fixed15_direct": dict(gauss_mode="fixed15", scaling_mode="direct"),
    "relative_all_interp": dict(gauss_mode="vlfeat-relative-all",
                                downscale_mode="interpolate"),
}
# the strategies that are not the incremental pick-every-second pyramid
NOT_THIN = ("fixed9", "fixed15", "relative_all", "interpolate", "direct",
            "fixed15_direct", "relative_all_interp")


def _tensor(img):
    return torch.from_numpy(np.ascontiguousarray(img))


@pytest.fixture(scope="module")
def image():
    return synthetic_image(64, 80, seed=3)


# ---------------------------------------------------------------------------
# pyramids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_pyramid_matches_jax(image, name):
    """Every level and DoG layer of every octave within 1e-4 of JAX, on
    both fronts, and the two fronts bit-equal."""
    cfg = SiftConfig(octaves=3, **STRATEGIES[name])
    jplan = jpyr.build_pyramid_plan(cfg, *image.shape)
    jb, jd = jax.jit(lambda x: jpyr.build_pyramid(x, jplan))(image)
    tplan = tpyr.build_pyramid_plan(port_config(cfg), *image.shape)
    level = tpyr.build_pyramid(_tensor(image), tplan)
    chain = tpyr.build_pyramid(_tensor(image), tplan, front="chain")
    for a, b in zip(level[0] + level[1], jb + jd):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PYR_TOL)
    for a, b in zip(level[0] + level[1], chain[0] + chain[1]):
        assert torch.equal(a, b)


def test_thin_entry_only_for_incremental_pick(image, monkeypatch):
    """K5's thin entry picks the next octave from a level it writes: under
    the interpolated downscale, direct scaling and the modes that blur
    from level 0 it must not run on either front (and the pyramids above
    still equal JAX's), while the default strategy takes it for its small
    octaves on both."""
    calls = []
    real = k5.blur_dog_thin_torch
    monkeypatch.setattr(tpyr, "blur_dog_thin_torch",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tpyr, "blur_dog_thin",
                        lambda *a: calls.append(1) or real(*a))
    for name in NOT_THIN:
        plan = tpyr.build_pyramid_plan(
            port_config(SiftConfig(octaves=3, **STRATEGIES[name])),
            *image.shape)
        assert tpyr.first_thin_octave(plan) == len(plan.dims), name
        tpyr.build_pyramid(_tensor(image), plan)
        tpyr.build_pyramid(_tensor(image), plan, front="chain")
        assert not calls, name
    plan = tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=3)),
                                   *image.shape)
    assert tpyr.first_thin_octave(plan) < len(plan.dims)
    tpyr.build_pyramid(_tensor(image), plan)
    assert calls
    calls.clear()
    tpyr.build_pyramid(_tensor(image), plan, front="chain")
    assert calls
    # the interpolated downscale takes the odd pixels, not the pick
    cfg = SiftConfig(octaves=3, downscale_mode="interpolate")
    plan = tpyr.build_pyramid_plan(port_config(cfg), *image.shape)
    blurs, _ = tpyr.build_pyramid(_tensor(image), plan)
    for o in (1, 2):
        prev = blurs[o - 1][cfg.total_levels - 3]
        assert torch.equal(blurs[o][0], tpyr._decimate2_interpolate(
            prev, *plan.dims[o]))
        assert not torch.equal(blurs[o][0], tpyr.pick_every_second(
            prev, *plan.dims[o]))


def test_interpolated_downscale_odd_dims():
    """Port of test_variants.py::test_interpolated_downscale_odd_dims."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(33, 41)).astype(np.float32)
    oh, ow = 17, 21
    got = tpyr._decimate2_interpolate(torch.from_numpy(x), oh, ow).numpy()
    yi = np.minimum(2 * np.arange(oh) + 1, 32)
    xi = np.minimum(2 * np.arange(ow) + 1, 40)
    np.testing.assert_array_equal(got, x[np.ix_(yi, xi)])
    np.testing.assert_array_equal(
        got, np.asarray(jpyr._decimate2_interpolate(jnp.asarray(x), oh, ow)))


@pytest.mark.parametrize("gauss_mode", ["fixed9", "fixed15"])
def test_fixed_mode_pyramid_matches_oracle(small_image, gauss_mode):
    """Port of test_variants.py::test_fixed_mode_pyramid_matches_oracle."""
    cfg = SiftConfig(octaves=3, gauss_mode=gauss_mode)
    blurs, _ = tpyr.build_pyramid(
        _tensor(small_image),
        tpyr.build_pyramid_plan(port_config(cfg), *small_image.shape))
    oblurs, _ = oracle_pyramid(small_image, cfg)
    for octv in range(3):
        assert np.max(np.abs(blurs[octv].numpy() - oblurs[octv])) < 5e-3
    inc, _ = tpyr.build_pyramid(
        _tensor(small_image),
        tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=3)),
                                *small_image.shape))
    assert float((blurs[0][3] - inc[0][3]).abs().max()) > 0.05


def test_fixed_mode_requires_levels3():
    with pytest.raises(ValueError):
        PortSiftConfig(gauss_mode="fixed9", levels=4)


def test_interpolated_downscale_matches_oracle(small_image):
    """Port of test_variants.py::test_interpolated_downscale_matches_oracle."""
    cfg = SiftConfig(octaves=3, downscale_mode="interpolate")
    blurs, _ = tpyr.build_pyramid(
        _tensor(small_image),
        tpyr.build_pyramid_plan(port_config(cfg), *small_image.shape))
    oblurs, _ = oracle_pyramid(small_image, cfg)
    for octv in (1, 2):
        assert np.max(np.abs(blurs[octv][0].numpy()
                             - oblurs[octv][0])) < 2e-3
    pick, _ = tpyr.build_pyramid(
        _tensor(small_image),
        tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=3)),
                                *small_image.shape))
    assert float((blurs[1][0] - pick[1][0]).abs().max()) > 0.05


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    rm = np.abs(want).max(1, keepdims=True)
    return float(np.where(rm > 0, np.abs(got - want) / np.maximum(rm, 1e-30),
                          np.abs(got)).max())


def _port_jobs(j) -> tdesc.DescriptorJobs:
    return tdesc.DescriptorJobs(
        *(torch.from_numpy(np.array(a)) for a in
          (j.x, j.y, j.sigma, np.asarray(j.level, np.int64), j.ang,
           np.asarray(j.kp_index, np.int64), j.valid)),
        count=torch.tensor(int(j.count)))


@pytest.fixture(scope="module")
def oracle_jobs(medium_image):
    """Real jobs (the oracle's octave-0 keypoints and orientations of the
    120 x 160 scene) plus a padding row that is not valid and a row with
    sigma 0, on the oracle's blur stack."""
    cfg = SiftConfig(octaves=1, threshold=0.02)
    blur, rows, jobs = _sample_jobs(medium_image, cfg, n=24)
    n = len(rows)
    pad = lambda a, v: jnp.concatenate([a, jnp.asarray([v, v], a.dtype)])
    jobs = jdesc.DescriptorJobs(
        x=pad(jobs.x, 40.0), y=pad(jobs.y, 30.0),
        sigma=jnp.concatenate([jobs.sigma, jnp.asarray([2.0, 0.0],
                                                       jnp.float32)]),
        level=pad(jobs.level, 1), ang=pad(jobs.ang, 1.0),
        kp_index=pad(jobs.kp_index, 0),
        valid=jnp.concatenate([jobs.valid, jnp.asarray([False, True])]),
        count=jnp.int32(n + 1))
    return blur, jobs


@pytest.mark.parametrize("mode", ["igrid", "notile", "grid", "iloop"])
def test_descriptor_variant_matches_jax(oracle_jobs, mode):
    blur, jobs = oracle_jobs
    cfg = SiftConfig(octaves=1, desc_mode=mode)
    want = np.asarray(jdesc.compute_descriptors(blur, jobs, cfg))
    got = tdesc.compute_descriptors(torch.from_numpy(np.array(blur)),
                                    _port_jobs(jobs), port_config(cfg))
    assert got.shape == want.shape
    assert np.abs(want[:-2]).max(1).min() > 0
    assert not got[-2:].any()             # not valid; sigma 0
    assert _rel_err(got.numpy(), want) < DESC_REL_TOL


@pytest.mark.parametrize("mode", ["igrid", "iloop"])
def test_descriptor_variant_clamps_like_jax(oracle_jobs, mode):
    """Random jobs, some centred off the image (the bilinear clamp) and
    on every level; the variants whose samples move continuously with
    the keypoint (``grid`` rounds its addresses, so a 1-ULP difference
    of cos or sin between XLA and torch can move a sample a pixel)."""
    blur, _ = oracle_jobs
    L, H, W = blur.shape
    rng = np.random.default_rng(4)
    n = 64
    f32 = lambda a: np.asarray(a, np.float32)
    cols = (f32(rng.uniform(-3, W + 3, n)), f32(rng.uniform(-3, H + 3, n)),
            f32(rng.uniform(1.5, 4.0, n)), rng.integers(0, L, n),
            f32(rng.uniform(0, 2 * np.pi, n)), np.zeros(n, np.int64),
            rng.random(n) < 0.9)
    jobs = jdesc.DescriptorJobs(*(jnp.asarray(c) for c in cols),
                                count=jnp.int32(n))
    cfg = SiftConfig(octaves=1, desc_mode=mode)
    want = np.asarray(jdesc.compute_descriptors(blur, jobs, cfg))
    got = tdesc.compute_descriptors(torch.from_numpy(np.array(blur)),
                                    _port_jobs(jobs), port_config(cfg))
    assert _rel_err(got.numpy(), want) < DESC_REL_TOL


def test_variant_chunks_and_octaves(oracle_jobs, monkeypatch):
    """Rows run in static chunks, each on its own octave's stack: many
    small chunks over two "octaves" give the rows of one chunk each."""
    blur, jobs = oracle_jobs
    cfg = port_config(SiftConfig(octaves=1, desc_mode="igrid"))
    tj = _port_jobs(jobs)
    b = torch.from_numpy(np.array(blur))
    whole = tdesc.compute_descriptors(b, tj, cfg)
    n = tj.x.shape[0]
    monkeypatch.setitem(tdesc._CHUNK_SAMPLES, "cpu",
                        3 * tdesc._ROW_SAMPLES["igrid"])
    assert tdesc.variant_chunk_rows("igrid", torch.device("cpu")) == 3
    b2 = b.flip(-1).contiguous()
    got = tdesc.descriptor_variant([b, b2], tj, [10, n], cfg)
    assert torch.equal(got[:10], whole[:10])
    tail = tdesc.compute_descriptors(b2, tdesc._jobs_rows(tj, 10, n), cfg)
    assert torch.equal(got[10:], tail)


def test_tilegrid_descriptor_matches_oracle(medium_image):
    """Port of test_variants.py::test_tilegrid_descriptor_matches_oracle."""
    cfg = SiftConfig(octaves=1, threshold=0.02)
    blur, rows, jobs = _sample_jobs(medium_image, cfg)
    got = tdesc._descriptor_tilegrid_chunk(torch.from_numpy(np.array(blur)),
                                           _port_jobs(jobs)).numpy()
    for i, (e, ang) in enumerate(rows):
        want = oracle_descriptor_tilegrid(np.asarray(blur), e, ang, cfg)
        denom = max(1e-3, float(np.abs(want).max()))
        assert np.max(np.abs(got[i] - want)) / denom < 5e-3, i


def test_iloop_descriptor_matches_oracle(medium_image):
    """Port of test_variants.py::test_iloop_descriptor_matches_oracle."""
    cfg = SiftConfig(octaves=1, threshold=0.02)
    blur, rows, jobs = _sample_jobs(medium_image, cfg, n=4)
    got = tdesc._descriptor_iloop_chunk(torch.from_numpy(np.array(blur)),
                                        _port_jobs(jobs)).numpy()
    for i, (e, ang) in enumerate(rows):
        want = oracle_descriptor_iloop(np.asarray(blur), e, ang, cfg)
        denom = max(1e-3, float(np.abs(want).max()))
        assert np.max(np.abs(got[i] - want)) / denom < 5e-3, i


def test_grid_differs_from_igrid(medium_image):
    """Port of test_variants.py::test_grid_differs_from_igrid: the port's
    grid and igrid are distinct, and igrid follows the oracle's grid."""
    cfg = SiftConfig(octaves=1, threshold=0.02)
    blur, rows, jobs = _sample_jobs(medium_image, cfg)
    b, tj = torch.from_numpy(np.array(blur)), _port_jobs(jobs)
    tg = tdesc._descriptor_tilegrid_chunk(b, tj)[0].numpy()
    ig = tdesc._descriptor_grid_chunk(b, tj)[0].numpy()
    cos = float(tg @ ig / (np.linalg.norm(tg) * np.linalg.norm(ig) + 1e-9))
    assert cos > 0.85 and np.max(np.abs(tg - ig)) > 1e-3
    e, ang = rows[0]
    want = oracle_descriptor_grid(np.asarray(blur), e, ang, cfg)
    assert np.max(np.abs(ig - want)) / np.abs(want).max() < 5e-3
