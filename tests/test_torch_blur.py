"""Plain version of kernel K5 (fused blur + DoG) against the JAX package
on the CPU, and the port's pyramid through K5's wrapper.

* ``blur_dog_torch`` against JAX ``blur_and_dog(..., interpret=True)``
  and JAX ``_sep_blur`` at the shapes, levels and atol 2e-4 of
  tests/test_pallas_blur.py:17-33, plus the edge rows and columns of
  :36-48 (atol 2e-5): the same shift-and-add in the same order, where
  XLA may fuse or contract terms that the port rounds one by one;
* the pyramid through the wrapper (one call per level for all frames)
  equals, bit for bit, the level-by-level chain of the plain blur and
  the stack subtraction that the port ran before K5 existed, and each
  frame of a batched pyramid equals its own pyramid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.gauss import build_gauss_tables, full_kernel
from popsift_tpu.ops.pallas.blur import blur_and_dog
from popsift_tpu.ops.pyramid import _sep_blur as jax_sep_blur
from popsift_tpu_torch.ops import kernels
from popsift_tpu_torch.ops import pyramid as tpyr
from popsift_tpu_torch.ops.kernels import blur_dog as K5
from test_torch_pipeline import port_config

torch.set_num_threads(1)


def _kernel(level):
    tables = build_gauss_tables(SiftConfig())
    return full_kernel(tables.inc[level], int(tables.inc_span[level]))


@pytest.mark.parametrize("shape", [(64, 80), (130, 200), (128, 128)])
@pytest.mark.parametrize("level", [1, 3, 5])
def test_blur_dog_matches_jax(shape, level, rng):
    k = _kernel(level)
    img = rng.normal(0, 64, size=shape).astype(np.float32) + 128.0
    want_blur = np.asarray(jax_sep_blur(jnp.asarray(img), k))
    p_blur, p_dog = blur_and_dog(jnp.asarray(img), k, interpret=True)
    blur, dog = K5.blur_dog_torch(torch.from_numpy(img)[None], k)
    blur, dog = blur[0].numpy(), dog[0].numpy()
    for ref in (want_blur, np.asarray(p_blur)):
        np.testing.assert_allclose(blur, ref, rtol=0, atol=2e-4)
    for ref in (want_blur - img, np.asarray(p_dog)):
        np.testing.assert_allclose(dog, ref, rtol=0, atol=2e-4)


def test_blur_dog_edge_replication(rng):
    k = _kernel(2)
    img = rng.normal(0, 1, size=(40, 48)).astype(np.float32)
    a = K5.blur_dog_torch(torch.from_numpy(img)[None], k)[0][0].numpy()
    for ref in (np.asarray(blur_and_dog(jnp.asarray(img), k,
                                        interpret=True)[0]),
                np.asarray(jax_sep_blur(jnp.asarray(img), k))):
        np.testing.assert_allclose(a[0], ref[0], atol=2e-5)
        np.testing.assert_allclose(a[-1], ref[-1], atol=2e-5)
        np.testing.assert_allclose(a[:, 0], ref[:, 0], atol=2e-5)
        np.testing.assert_allclose(a[:, -1], ref[:, -1], atol=2e-5)


def test_wrapper_writes_strided_planes_on_cpu(rng):
    """The wrapper runs the plain version for CPU tensors, writes into
    strided level views of a [N, L, H, W] stack and counts no launch."""
    k = _kernel(4)
    stack = torch.from_numpy(
        rng.normal(100, 30, size=(3, 4, 33, 47)).astype(np.float32))
    want = K5.blur_dog_torch(stack[:, 1].clone(), k)
    kernels.reset_launch_counts()
    got = K5.blur_dog(stack[:, 1], k, out=(stack[:, 2], stack[:, 3]))
    assert got[0].data_ptr() == stack[:, 2].data_ptr()
    assert torch.equal(stack[:, 2], want[0])
    assert torch.equal(stack[:, 3], want[1])
    assert kernels.launch_counts()[K5.NAME] == 0


def _chain_pyramid(img, plan):
    """The port's pyramid before K5: each level from the previous one by
    the plain blur, then the DoGs as one stack subtraction."""
    total = plan.config.total_levels
    blurs, dogs, prev = [], [], None
    for octv, (oh, ow) in enumerate(plan.dims):
        lv = [tpyr._octave0_level0(img, plan) if octv == 0
              else prev[0::2, 0::2][:oh, :ow]]
        for lvl in range(1, total):
            lv.append(K5._sep_blur(lv[-1], plan.inc_kernels[lvl]))
        levels = torch.stack(lv)
        blurs.append(levels)
        dogs.append(levels[1:] - levels[:-1])
        prev = levels[total - 3]
    return blurs, dogs


@pytest.mark.parametrize("h,w,octaves,seed", [(64, 80, 3, 3),
                                              (120, 160, 4, 7),
                                              (67, 93, -1, 1)])
def test_pyramid_through_wrapper_is_exact(h, w, octaves, seed):
    cfg = port_config(SiftConfig(octaves=octaves))
    plan = tpyr.build_pyramid_plan(cfg, h, w)
    img = torch.from_numpy(synthetic_image(h, w, seed=seed))
    wb, wd = _chain_pyramid(img, plan)
    for plain in (False, True):
        tb, td = tpyr.build_pyramid(img, plan, plain=plain)
        assert len(tb) == len(wb) == len(td) == len(wd)
        for a, b in zip(tb + td, wb + wd):
            assert a.shape == b.shape and torch.equal(a, b)


def test_batched_pyramid_equals_each_frame():
    cfg = port_config(SiftConfig(octaves=3))
    plan = tpyr.build_pyramid_plan(cfg, 48, 64)
    imgs = np.stack([synthetic_image(48, 64, seed=s) for s in range(3)])
    bb, bd = tpyr.build_pyramid_frames(torch.from_numpy(imgs), plan)
    L = cfg.total_levels
    for f in range(3):
        sb, sd = tpyr.build_pyramid(torch.from_numpy(imgs[f]), plan)
        for o in range(len(sb)):
            assert bb[o].shape[:2] == (3, L) and bd[o].shape[:2] == (3, L - 1)
            assert torch.equal(bb[o][f], sb[o])
            assert torch.equal(bd[o][f], sd[o])
