"""popsift_tpu_torch orientation against the JAX package on the CPU.

* raw histograms (plain version of kernel K3) match
  ``_orientation_hist_xla`` within 1e-5 x the row's max (summation order
  differs; a pixel whose atan2 lands within an ULP of a bin edge could
  still move, which these inputs do not hit);
* the smoothing + peak tail matches ``orientations_from_histograms``:
  ``ori_valid`` and ``num_ori`` exact, angles within 1e-5 rad, including
  a histogram with tied peaks (lax.top_k breaks ties toward the lower
  index; the port's stable sort must too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops import orientation as jori
from popsift_tpu.ops import pyramid as jpyr
from popsift_tpu_torch.ops import orientation as tori
from popsift_tpu_torch.ops.extrema import OctaveExtrema
from test_torch_pipeline import port_config

torch.set_num_threads(1)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _scene_extrema(h, w, octaves, seed):
    """JAX pyramid + refined extrema of every octave of a golden scene."""
    cfg = SiftConfig(octaves=octaves)
    plan = jpyr.build_pyramid_plan(cfg, h, w)
    blurs, dogs = jax.jit(lambda x: jpyr.build_pyramid(x, plan))(
        synthetic_image(h, w, seed=seed))
    out = []
    for o, dog in enumerate(dogs):
        H, W = plan.dims[o]
        ext = jext.refine_candidates(jext.collect_candidates(dog, cfg, 128),
                                     cfg, W, H)
        out.append((blurs[o], ext))
    return cfg, out


def _random_extrema(blur, n, seed):
    """Random keypoints over the whole octave, borders and the largest
    sigma included, as a JAX-shaped OctaveExtrema."""
    L, H, W = blur.shape
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(1.6, 5.0, n).astype(np.float32)
    x = rng.uniform(0, W - 1, n).astype(np.float32)
    y = rng.uniform(0, H - 1, n).astype(np.float32)
    x[:4] = [0.0, W - 1.0, 0.4, W - 1.4]
    y[:4] = [0.3, H - 1.0, H - 1.2, 0.0]
    level = rng.integers(0, L, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    z = np.zeros(n, np.float32)
    return jext.OctaveExtrema(
        x=jnp.asarray(np.where(valid, x, 0)), y=jnp.asarray(np.where(valid, y, 0)),
        s=jnp.asarray(z), level=jnp.asarray(level),
        sigma=jnp.asarray(np.where(valid, sigma, 0)),
        cell=jnp.zeros(n, jnp.int32), valid=jnp.asarray(valid),
        count=jnp.int32(valid.sum()), n_candidates=jnp.int32(n),
        n_dropped=jnp.int32(0))


def _port_hist(blur, ext, cfg):
    e = OctaveExtrema(
        x=_t(ext.x), y=_t(ext.y), s=_t(ext.s), level=_t(ext.level),
        sigma=_t(ext.sigma), cell=_t(ext.cell), valid=_t(ext.valid),
        count=None, n_candidates=None, n_dropped=None)
    return tori.orientation_histograms(torch.from_numpy(np.array(blur)),
                                       e, port_config(cfg),
                                       e.x.shape[0]).numpy()


def _assert_rows_close(got, want, rel=1e-5):
    rowmax = np.abs(want).max(1, keepdims=True)
    assert np.all(np.abs(got - want) <= rel * rowmax + 1e-30)


def test_histograms_match_xla_on_scene():
    cfg, octs = _scene_extrema(120, 160, 4, seed=7)
    R = jori.max_ori_radius(cfg)
    nonzero = 0
    for blur, ext in octs:
        want = np.asarray(jori._orientation_hist_xla(blur, ext, cfg, R))
        got = _port_hist(blur, ext, cfg)
        _assert_rows_close(got, want)
        nonzero += int((want.sum(1) > 0).sum())
    assert nonzero > 10


def test_histograms_match_xla_random_keypoints():
    cfg = SiftConfig()
    rng = np.random.default_rng(4)
    blur = jnp.asarray((rng.random((6, 50, 70)) * 255).astype(np.float32))
    ext = _random_extrema(blur, 96, seed=9)
    want = np.asarray(jori._orientation_hist_xla(
        blur, ext, cfg, jori.max_ori_radius(cfg)))
    got = _port_hist(blur, ext, cfg)
    _assert_rows_close(got, want)
    assert np.all(got[~np.asarray(ext.valid)] == 0)


def _tail_inputs(seed):
    rng = np.random.default_rng(seed)
    hist = (rng.random((64, 36)) ** 4 * 50).astype(np.float32)
    # exact ties: two identical halves give identical smoothed peaks
    half = (rng.random(18) * 10).astype(np.float32)
    hist[0] = np.concatenate([half, half])
    hist[1] = np.zeros(36, np.float32)
    hist[1, [3, 12, 21, 30]] = 7.0
    valid = rng.random(64) < 0.9
    valid[:2] = True
    return hist, valid


@pytest.mark.parametrize("smoothing", ["vlfeat", "opencv"])
def test_orientation_tail_matches_jax(smoothing):
    hist, valid = _tail_inputs(seed=1)
    want = jori.orientations_from_histograms(
        jnp.asarray(hist), jnp.asarray(valid), smoothing=smoothing)
    got = tori.orientations_from_histograms(
        torch.from_numpy(hist), torch.from_numpy(valid), smoothing=smoothing)
    assert np.array_equal(got.ori_valid.numpy(), np.asarray(want.ori_valid))
    assert np.array_equal(got.num_ori.numpy(), np.asarray(want.num_ori))
    np.testing.assert_allclose(got.ori.numpy(), np.asarray(want.ori),
                               rtol=0, atol=1e-5)
    assert got.num_ori[0] >= 2 and got.num_ori[1] == 4   # ties accepted


def test_tied_peaks_keep_lower_index_first():
    hist = np.zeros((1, 36), np.float32)
    hist[0, [5, 23]] = 3.0
    got = tori.orientations_from_histograms(
        torch.from_numpy(hist), torch.ones(1, dtype=torch.bool))
    want = jori.orientations_from_histograms(
        jnp.asarray(hist), jnp.ones(1, bool))
    assert int(got.num_ori[0]) == 2
    np.testing.assert_allclose(got.ori.numpy(), np.asarray(want.ori),
                               rtol=0, atol=1e-5)
    assert got.ori[0, 0] < got.ori[0, 1]     # bin 5 before bin 23
