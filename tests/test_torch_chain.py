"""The chain front of the port (kernel K7's plain version on the CPU)
against the JAX package: ``octave_blur_chain`` in interpret mode for
group None, 3 and 2, and the ``_sep_blur`` chain, both within 1e-4 on
the 0..255 scale (tests/test_pallas_blur.py:99-128 holds the Pallas
kernel to its twin the same way); ``build_pyramid(front="chain")``
against ``front="level"``, exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.gauss import build_gauss_tables, full_kernel
from popsift_tpu.ops.pallas.blur import octave_blur_chain
from popsift_tpu.ops.pyramid import _sep_blur as jax_sep_blur
from popsift_tpu_torch.ops import kernels
from popsift_tpu_torch.ops import pyramid as tpyr
from popsift_tpu_torch.ops.kernels import blur_chain as K7
from popsift_tpu_torch.ops.kernels import blur_dog as K5
from test_torch_pipeline import port_config

torch.set_num_threads(1)
ATOL = 1e-4


def _kernels():
    cfg = SiftConfig()
    tables = build_gauss_tables(cfg)
    return [full_kernel(tables.inc[l], int(tables.inc_span[l]))
            for l in range(1, cfg.total_levels)]


def _level0(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(96, 40, size=(H, W)).astype(np.float32)


@pytest.mark.parametrize("group", [None, 3, 2])
def test_chain_matches_pallas_interpret(group):
    kernels_ = _kernels()
    lvl0 = _level0(75, 131)
    jb, jd = octave_blur_chain(jnp.asarray(lvl0), kernels_, interpret=True,
                               group=group)
    blurs, dogs = K7.blur_chain(torch.from_numpy(lvl0)[None], kernels_,
                                group=group)
    assert blurs.shape == dogs.shape == (1, len(kernels_), 75, 131)
    for l in range(len(kernels_)):
        np.testing.assert_allclose(blurs[0, l].numpy(), np.asarray(jb[l]),
                                   rtol=0, atol=ATOL, err_msg=f"level {l + 1}")
        np.testing.assert_allclose(dogs[0, l].numpy(), np.asarray(jd[l]),
                                   rtol=0, atol=ATOL, err_msg=f"dog {l}")


@pytest.mark.parametrize("shape", [(75, 131), (9, 15), (64, 64)])
def test_chain_matches_jax_sep_blur_chain(shape):
    """Every level is the edge-replicated blur of the level before it,
    also where the image is smaller than the filters' halo."""
    kernels_ = _kernels()
    lvl0 = _level0(*shape, seed=3)
    blurs, dogs = K7.blur_chain(torch.from_numpy(lvl0)[None], kernels_, 3)
    prev = jnp.asarray(lvl0)
    for l, k in enumerate(kernels_):
        want = jax_sep_blur(prev, k)
        np.testing.assert_allclose(blurs[0, l].numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL, err_msg=f"level {l + 1}")
        np.testing.assert_allclose(dogs[0, l].numpy(),
                                   np.asarray(want - prev), rtol=0,
                                   atol=ATOL, err_msg=f"dog {l}")
        prev = want


def test_chain_equals_level_by_level_kernel_version():
    """The chain's levels are K5's, bit for bit, for every plane of a
    batch and written into strided views of a level stack."""
    kernels_ = _kernels()
    N, H, W, n = 3, 40, 52, len(kernels_)
    src = torch.from_numpy(np.stack([_level0(H, W, seed=s)
                                     for s in range(N)]))
    levels = torch.zeros((N, n + 1, H, W))
    dog = torch.zeros((N, n, H, W))
    levels[:, 0] = src
    out = K7.blur_chain(levels[:, 0], kernels_, 3,
                        out=(levels[:, 1:], dog))
    assert out[0].data_ptr() == levels[:, 1:].data_ptr()
    prev = src
    for l, k in enumerate(kernels_):
        b, d = K5.blur_dog(prev, k)
        assert torch.equal(levels[:, l + 1], b), l
        assert torch.equal(dog[:, l], d), l
        prev = b
    assert torch.equal(levels[:, 0], src)


@pytest.mark.parametrize("h,w,octaves,seed", [(64, 80, 3, 3),
                                              (120, 160, 4, 7),
                                              (67, 93, -1, 1)])
def test_pyramid_chain_front_equals_level_front(h, w, octaves, seed):
    kernels.reset_launch_counts()
    plan = tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=octaves)),
                                   h, w)
    img = torch.from_numpy(synthetic_image(h, w, seed=seed))
    lb, ld = tpyr.build_pyramid(img, plan)
    for plain in (False, True):
        cb, cd = tpyr.build_pyramid(img, plan, plain=plain, front="chain")
        assert len(cb) == len(lb) and len(cd) == len(ld)
        for a, b in zip(cb + cd, lb + ld):
            assert a.shape == b.shape and torch.equal(a, b)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_batched_chain_front_equals_each_frame():
    plan = tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=3)), 48, 64)
    imgs = np.stack([synthetic_image(48, 64, seed=s) for s in range(3)])
    bb, bd = tpyr.build_pyramid_frames(torch.from_numpy(imgs), plan,
                                       front="chain")
    for f in range(3):
        sb, sd = tpyr.build_pyramid(torch.from_numpy(imgs[f]), plan)
        for o in range(len(sb)):
            assert torch.equal(bb[o][f], sb[o])
            assert torch.equal(bd[o][f], sd[o])


def test_unknown_front_raises():
    plan = tpyr.build_pyramid_plan(port_config(SiftConfig(octaves=2)), 32, 40)
    with pytest.raises(ValueError, match="front"):
        tpyr.build_pyramid(torch.zeros((32, 40), dtype=torch.uint8), plan,
                           front="octave")
    with pytest.raises(ValueError, match="at least one level"):
        K7.blur_chain(torch.zeros((1, 8, 8)), [])
