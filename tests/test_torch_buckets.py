"""The patch-fed descriptor entry and the bucketed launches of K3 and K4
(their plain versions on the CPU) against the JAX package's Pallas
kernels in interpret mode, at the tolerances tests/test_pallas_desc.py
holds those kernels to (2e-5 x the descriptors' max, 3e-5 x the
histograms' max), and against the port's own single-launch entries.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.config import DESC_MAGNIFY, ORI_WINFACTOR, SiftConfig
from popsift_tpu.ops import patches as jpatches
from popsift_tpu.ops.descriptors import DescriptorJobs, loop_patch_radius
from popsift_tpu.ops.extrema import OctaveExtrema
from popsift_tpu.ops.orientation import max_ori_radius
from popsift_tpu.ops.pallas.desc import (descriptor_loop_pallas,
                                         descriptor_loop_pallas_bucketed)
from popsift_tpu.ops.pallas.orient import orientation_hist_pallas_bucketed
from popsift_tpu_torch.ops import descriptors as tdesc
from popsift_tpu_torch.ops import kernels
from popsift_tpu_torch.ops import orientation as tori
from popsift_tpu_torch.ops import patches as tpatches
from popsift_tpu_torch.ops.kernels import desc as K4
from popsift_tpu_torch.ops.kernels import orient as K3
from test_torch_pipeline import port_config

torch.set_num_threads(1)
CFG = SiftConfig()
SIGMA_SPLIT = CFG.sigma * 2.0 ** (2.5 / CFG.levels)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jobs(rng, F, H, W, split=False):
    """The job mix of tests/test_pallas_desc.py::_jobs; with ``split``
    half the sigmas lie above the bucket split."""
    sigma = rng.uniform(1.2, 2.8, F).astype(np.float32)
    if split:
        sigma[::2] = rng.uniform(SIGMA_SPLIT + 0.2, 4.4,
                                 len(sigma[::2])).astype(np.float32)
    valid = np.ones(F, bool)
    valid[-1] = False
    return dict(x=rng.uniform(8, W - 8, F).astype(np.float32),
                y=rng.uniform(8, H - 8, F).astype(np.float32), sigma=sigma,
                level=rng.integers(0, 3, F).astype(np.int32),
                ang=rng.uniform(-np.pi, np.pi, F).astype(np.float32),
                valid=valid)


def _jax_jobs(j):
    F = len(j["x"])
    return DescriptorJobs(
        **{k: jnp.asarray(v) for k, v in j.items()},
        kp_index=jnp.arange(F, dtype=jnp.int32), count=jnp.int32(F - 1))


def _padded(blur, H, W):
    """Edge padding that the window kernels' aligned reads need
    (tests/test_pallas_desc.py:185-187)."""
    Hp = max(-(-(H + 64) // 8) * 8, 112)
    Wp = max(-(-(W + 240) // 128) * 128, 256)
    return jnp.pad(jnp.asarray(blur), ((0, 0), (0, Hp - H), (0, Wp - W)),
                   mode="edge")


@pytest.mark.parametrize("shape", [(96, 128), (60, 70)])
def test_patch_extraction_matches_jax(shape):
    H, W = shape
    rng = np.random.default_rng(1)
    blur = rng.normal(64, 32, size=(6, H, W)).astype(np.float32)
    rows, cols, K = 104, 128, 12
    cy = rng.integers(-3, H + 3, K).astype(np.int32)
    cx = rng.integers(-3, W + 3, K).astype(np.int32)
    level = rng.integers(-1, 8, K).astype(np.int32)
    jp, jy, jx = jpatches.extract_patches_rect(
        jpatches.pad_for_patches(jnp.asarray(blur), max(rows, cols)),
        jnp.asarray(level), jnp.asarray(cy), jnp.asarray(cx), rows, cols,
        51, 51)
    tp, ty, tx = tpatches.extract_patches_rect(
        tpatches.pad_for_patches(_t(blur), max(rows, cols)), _t(level),
        _t(cy), _t(cx), rows, cols, 51, 51)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    with pytest.raises(ValueError, match="pad it first"):
        tpatches.extract_patches_rect(_t(blur), _t(level), _t(cy), _t(cx),
                                      rows, cols, 51, 51)


def test_patch_descriptors_match_pallas_interpret():
    H, W, F = 96, 128, 16
    rng = np.random.default_rng(7)
    blur = rng.normal(64, 32, size=(CFG.total_levels, H, W)).astype(
        np.float32)
    radius = loop_patch_radius(CFG)
    rows = -(-(2 * radius + 1) // 8) * 8
    cols = -(-(2 * radius + 1) // 128) * 128
    j = _jobs(rng, F, H, W)
    jj = _jax_jobs(j)
    xr, yr = np.round(j["x"]).astype(np.int32), np.round(j["y"]).astype(
        np.int32)
    jp, jy0, jx0 = jpatches.extract_patches_rect(
        jpatches.pad_for_patches(jnp.asarray(blur), max(rows, cols)),
        jj.level, jnp.asarray(yr), jnp.asarray(xr), rows, cols, radius,
        radius)
    want = np.asarray(descriptor_loop_pallas(jp, jy0, jx0, jj, H, W,
                                             interpret=True))
    tp, ty0, tx0 = tpatches.extract_patches_rect(
        tpatches.pad_for_patches(_t(blur), max(rows, cols)), _t(j["level"]),
        _t(yr), _t(xr), rows, cols, radius, radius)
    got = K4.descriptor_loop_patches(tp, ty0, tx0, _t(j["x"]), _t(j["y"]),
                                     _t(j["sigma"]), _t(j["ang"]),
                                     _t(j["valid"]), H, W).numpy()
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    assert np.abs(got[-1]).max() == 0.0
    # the stack-fed entry gives the same descriptors: every job's support
    # lies inside its window and inside the image here
    stack = K4.descriptor_loop(_t(blur), _t(j["x"]), _t(j["y"]),
                               _t(j["sigma"]), _t(j["level"]), _t(j["ang"]),
                               _t(j["valid"]), F, radius).numpy()
    np.testing.assert_allclose(got, stack, rtol=0, atol=2e-5 * scale)


def test_bucketed_descriptors_match_pallas_interpret():
    H, W, F = 96, 128, 16
    rng = np.random.default_rng(8)
    blur = rng.normal(64, 32, size=(CFG.total_levels, H, W)).astype(
        np.float32)
    radius = loop_patch_radius(CFG)
    radius_small = int(math.ceil(2.5 * math.sqrt(2.0) * DESC_MAGNIFY
                                 * SIGMA_SPLIT)) + 2
    j = _jobs(rng, F, H, W, split=True)
    want = np.asarray(descriptor_loop_pallas_bucketed(
        _padded(blur, H, W), _jax_jobs(j), radius, SIGMA_SPLIT, radius_small,
        H, W, interpret=True))
    args = (_t(blur), _t(j["x"]), _t(j["y"]), _t(j["sigma"]), _t(j["level"]),
            _t(j["ang"]), _t(j["valid"]))
    got = K4.descriptor_loop_bucketed(*args, radius, SIGMA_SPLIT,
                                      radius_small).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    assert np.abs(got[-1]).max() == 0.0
    assert (j["sigma"][:-1] <= SIGMA_SPLIT).any() \
        and (j["sigma"][:-1] > SIGMA_SPLIT).any()
    # against the port's single launch over all rows
    single = K4.descriptor_loop(*args, F, radius).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-5 * scale)
    # three buckets route the same rows
    multi = K4.descriptor_loop_multibucket(
        *args, [(1.6, radius_small), (SIGMA_SPLIT, radius_small),
                (None, radius)]).numpy()
    np.testing.assert_allclose(multi, single, rtol=0, atol=1e-5 * scale)


def test_bucketed_histograms_match_pallas_interpret():
    H, W, K = 96, 160, 16
    rng = np.random.default_rng(9)
    blur = rng.normal(96, 40, size=(CFG.total_levels, H, W)).astype(
        np.float32)
    valid = np.ones(K, bool)
    valid[-2:] = False
    sig = rng.uniform(1.2, 2.6, K).astype(np.float32)
    sig[::2] = rng.uniform(SIGMA_SPLIT + 0.2, 4.8,
                           len(sig[::2])).astype(np.float32)
    x = rng.uniform(3, W - 3, K).astype(np.float32)
    y = rng.uniform(3, H - 3, K).astype(np.float32)
    level = rng.integers(0, 3, K).astype(np.int32)
    ext = OctaveExtrema(
        x=jnp.asarray(x), y=jnp.asarray(y), s=jnp.zeros(K, jnp.float32),
        level=jnp.asarray(level), sigma=jnp.asarray(sig),
        cell=jnp.zeros(K, jnp.int32), valid=jnp.asarray(valid),
        count=jnp.int32(K - 2), n_candidates=jnp.int32(K),
        n_dropped=jnp.int32(0))
    R = max_ori_radius(CFG)
    radius_small = int(round(3.0 * ORI_WINFACTOR * SIGMA_SPLIT))
    want = np.asarray(orientation_hist_pallas_bucketed(
        _padded(blur, H, W), ext, R, SIGMA_SPLIT, radius_small, H, W,
        interpret=True))
    args = (_t(blur), _t(x), _t(y), _t(sig), _t(level), _t(valid))
    got = K3.orientation_hist_bucketed(*args, R, SIGMA_SPLIT,
                                       radius_small).numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * scale)
    assert np.all(got[~valid] == 0)
    single = K3.orientation_hist(*args, K, R).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-5 * scale)


def test_extraction_path_does_not_bucket():
    """The radii the bucketed entries are called with come from the
    port's own bounds; the extraction path keeps the single launches."""
    tcfg = port_config(CFG)
    assert tdesc.loop_patch_radius(tcfg) == loop_patch_radius(CFG)
    assert tori.max_ori_radius(tcfg) == max_ori_radius(CFG)
    names = set(kernels.ENTRIES)
    assert {"orientation_hist_bucketed", "descriptor_loop_bucketed",
            "descriptor_loop_patches", "extract_windows",
            "extract_windows_batched", "blur_chain"} <= names
    assert all(n == 0 for n in kernels.launch_counts().values())
