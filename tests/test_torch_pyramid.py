"""popsift_tpu_torch pyramid against the JAX package on the CPU.

The plan (octave dims and every filter tap) must equal the JAX plan for
the same config and size, 1080p included. Levels and DoGs are the same
shift-and-add ops in the same order, so they agree to a few ULP on the
0..255 scale; the difference is XLA's FMA/fusion choices (atol 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import pyramid as jpyr
from popsift_tpu_torch.ops import pyramid as tpyr
from test_torch_pipeline import port_config

torch.set_num_threads(1)


@pytest.mark.parametrize("h,w,octaves", [(64, 80, 3), (120, 160, 4),
                                         (67, 93, -1), (1080, 1920, -1)])
def test_plan_equal_tap_for_tap(h, w, octaves):
    cfg = SiftConfig(octaves=octaves)
    jp = jpyr.build_pyramid_plan(cfg, h, w)
    tp = tpyr.build_pyramid_plan(port_config(cfg), h, w)
    assert tp.dims == jp.dims and tp.shift0 == jp.shift0
    assert (tp.in_h, tp.in_w) == (jp.in_h, jp.in_w)
    for field in ("inc_kernels", "absN_kernels", "dd_kernels",
                  "abs0_kernels"):
        a, b = getattr(tp, field), getattr(jp, field)
        assert len(a) == len(b)
        for ka, kb in zip(a, b):
            assert ka.dtype == kb.dtype and np.array_equal(ka, kb), field
    assert np.array_equal(tp.lvl0_kernel_x, jp.lvl0_kernel_x)
    assert np.array_equal(tp.lvl0_kernel_y, jp.lvl0_kernel_y)
    for (ta, qa), (tb, qb) in zip(
            tpyr._phase_kernels(tp.lvl0_kernel_x * 255.0),
            jpyr._phase_kernels(jp.lvl0_kernel_x * 255.0)):
        assert qa == qb and np.array_equal(ta, tb)


@pytest.mark.parametrize("h,w,octaves,seed", [(64, 80, 3, 3),
                                              (120, 160, 4, 7)])
def test_pyramid_matches_jax(h, w, octaves, seed):
    cfg = SiftConfig(octaves=octaves)
    img = synthetic_image(h, w, seed=seed)
    jplan = jpyr.build_pyramid_plan(cfg, h, w)
    jb, jd = jax.jit(lambda x: jpyr.build_pyramid(x, jplan))(img)
    tb, td = tpyr.build_pyramid(torch.from_numpy(img),
                                tpyr.build_pyramid_plan(port_config(cfg),
                                                       h, w))
    assert len(tb) == len(jb) == len(td) == len(jd)
    for a, b in zip(tb, jb):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    for a, b in zip(td, jd):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_float_input_matches_jax():
    """ImageFloat input ([0, 1] float32) takes the same front."""
    cfg = SiftConfig(octaves=2)
    img = synthetic_image(40, 48, seed=1).astype(np.float32) / 255.0
    jplan = jpyr.build_pyramid_plan(cfg, 40, 48)
    jb, _ = jax.jit(lambda x: jpyr.build_pyramid(x, jplan))(img)
    tb, _ = tpyr.build_pyramid(torch.from_numpy(img),
                               tpyr.build_pyramid_plan(port_config(cfg),
                                                       40, 48))
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("kw", [dict(gauss_mode="fixed9"),
                                dict(scaling_mode="direct"),
                                dict(downscale_mode="interpolate"),
                                dict(gauss_mode="vlfeat-relative-all")])
def test_non_default_strategies_raise(kw):
    """The strategies the port once refused now build JAX's pyramid
    (within 1e-4 on the 0..255 scale)."""
    cfg = SiftConfig(octaves=2, **kw)
    img = synthetic_image(32, 40, seed=2)
    jplan = jpyr.build_pyramid_plan(cfg, 32, 40)
    jb, jd = jax.jit(lambda x: jpyr.build_pyramid(x, jplan))(img)
    tb, td = tpyr.build_pyramid(torch.from_numpy(img),
                                tpyr.build_pyramid_plan(port_config(cfg), 32,
                                                        40))
    for a, b in zip(tb + td, jb + jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
