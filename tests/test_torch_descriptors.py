"""popsift_tpu_torch descriptors against the JAX package on the CPU.

* the segmented job build is exact, padding rows included;
* raw loop descriptors (plain version of kernel K4) match
  ``compute_descriptors(use_pallas=False)`` within 1e-5 x the row's max
  (the tile contraction sums in another order);
* RootSift and classic L2 normalisation match within 1e-6.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import descriptors as jdesc
from popsift_tpu_torch.ops import descriptors as tdesc
from test_torch_pipeline import port_config

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_segmented_job_build_exact():
    rng = np.random.default_rng(0)
    segs = ((0, 40, 50), (40, 24, 30), (64, 16, 20))
    N = 80
    ori_valid = rng.random((N, 4)) < 0.3
    ori_valid[64:80] = True                 # overfull segment: clamps at jcap
    ori_valid[40:64] = False                # empty segment
    x, y, sigma = (rng.random(N).astype(np.float32) * 50 for _ in range(3))
    level = rng.integers(0, 6, N).astype(np.int32)
    ori = (rng.random((N, 4)) * 6 - 3).astype(np.float32)
    jj, jc = jdesc.make_descriptor_jobs_segmented(
        *(jnp.asarray(a) for a in (x, y, sigma, level, ori, ori_valid)),
        segs)
    tj, tc = tdesc.make_descriptor_jobs_segmented(
        *(_t(a) for a in (x, y, sigma, level, ori, ori_valid)), segs)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert int(tj.count) == int(jj.count)
    for f in ("x", "y", "sigma", "level", "ang", "kp_index", "valid"):
        assert np.array_equal(getattr(tj, f).numpy(),
                              np.asarray(getattr(jj, f))), f


def _jobs(blur_shape, n, count, seed):
    """Random front-packed jobs over the octave, borders and sigmas past
    the static window bound included."""
    L, H, W = blur_shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, W - 1, n).astype(np.float32)
    y = rng.uniform(0, H - 1, n).astype(np.float32)
    x[:3] = [0.2, W - 1.0, W / 2]
    y[:3] = [H - 1.3, 0.0, H / 2]
    sigma = rng.uniform(1.6, 5.1, n).astype(np.float32)
    sigma[5] = 0.0                          # sbp == 0 -> zero row
    level = rng.integers(0, L, n).astype(np.int32)
    ang = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    valid = np.arange(n) < count
    return x, y, sigma, level, ang, valid


@pytest.mark.parametrize("shape,seed", [((6, 60, 90), 1), ((6, 140, 120), 2)])
def test_loop_descriptors_match_xla(shape, seed):
    cfg = SiftConfig()
    rng = np.random.default_rng(seed)
    blur = (rng.random(shape) * 255).astype(np.float32)
    n, count = 48, 40
    x, y, sigma, level, ang, valid = _jobs(shape, n, count, seed)
    jj = jdesc.DescriptorJobs(
        x=jnp.asarray(x), y=jnp.asarray(y), sigma=jnp.asarray(sigma),
        level=jnp.asarray(level), ang=jnp.asarray(ang),
        kp_index=jnp.zeros(n, jnp.int32), valid=jnp.asarray(valid),
        count=jnp.int32(count))
    want = np.asarray(jdesc.compute_descriptors(jnp.asarray(blur), jj, cfg,
                                                use_pallas=False))
    tj = tdesc.DescriptorJobs(
        x=_t(x), y=_t(y), sigma=_t(sigma), level=_t(level), ang=_t(ang),
        kp_index=torch.zeros(n, dtype=torch.long), valid=_t(valid),
        count=count)
    got = tdesc.compute_descriptors(torch.from_numpy(blur), tj,
                                    port_config(cfg)).numpy()
    rowmax = np.abs(want).max(1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * rowmax + 1e-30)
    assert np.all(got[count:] == 0) and np.all(got[5] == 0)
    assert (rowmax[:count] > 0).sum() >= count - 1


@pytest.mark.parametrize("norm_mode,mult", [("rootsift", 0), ("classic", 0),
                                            ("rootsift", 9)])
def test_normalisation_matches_jax(norm_mode, mult):
    cfg = SiftConfig(norm_mode=norm_mode, norm_multiplier=mult)
    rng = np.random.default_rng(3)
    d = (rng.random((32, 128)) ** 3 * 40).astype(np.float32)
    d[0] = 0.0
    d[1, :5] = 500.0                         # L2 clamp at 0.2 binds
    want = np.asarray(jdesc.normalize_descriptors(jnp.asarray(d), cfg))
    got = tdesc.normalize_descriptors(torch.from_numpy(d),
                                      port_config(cfg)).numpy()
    scale = 2.0 ** mult
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)


def test_other_descriptor_modes_raise():
    """The modes the port once refused now run; a job that is not valid
    gives a zero row."""
    jobs = tdesc.DescriptorJobs(
        *(torch.zeros(1) for _ in range(3)), torch.zeros(1, dtype=torch.long),
        torch.zeros(1), torch.zeros(1, dtype=torch.long),
        torch.zeros(1, dtype=torch.bool), count=torch.tensor(0))
    for mode in ("igrid", "notile", "grid", "iloop"):
        cfg = port_config(SiftConfig(desc_mode=mode))
        out = tdesc.compute_descriptors(torch.ones((6, 8, 8)), jobs, cfg)
        assert out.shape == (1, 128) and not out.any(), mode
