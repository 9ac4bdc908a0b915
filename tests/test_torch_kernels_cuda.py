"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests need a CUDA
device (and nvcc, to build popsift_tpu_torch/csrc on first use); they
skip without one. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances: blur/DoG levels, masks and refinement state exact (the
kernels are built with -fmad=false and follow the plain version op for
op); histograms and descriptors within 1e-5 x the row's max (fixed-order
sums in another order than the plain version's reductions).
"""

import math

import numpy as np
import pytest
import torch

from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.ops import extrema
from popsift_tpu.gauss import build_gauss_tables, full_kernel
from popsift_tpu_torch.ops.kernels import (blur_dog, desc, extrema_mask,
                                           orient, refine)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _dog(dev, D=5, H=97, W=131, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(D, H, W)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (1, 2):
        base = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, base)
    return torch.from_numpy((base * 60).astype(np.float32)).to(dev)


def _rel_rows(got, ref):
    rowmax = ref.abs().amax(1, keepdim=True)
    return bool(((got - ref).abs() <= 1e-5 * rowmax + 1e-30).all())


def test_extrema_mask_kernel(dev):
    dog = _dog(dev)
    before = extrema_mask.launches
    got = extrema_mask.candidate_mask(dog, 2.72)
    assert extrema_mask.launches == before + 1
    ref = extrema_mask.candidate_mask_torch(dog, 2.72)
    assert ref.sum() > 0 and torch.equal(got, ref)


@pytest.mark.parametrize("vlfeat", [False, True])
def test_refine_kernel(dev, vlfeat):
    cfg = SiftConfig(sift_mode="vlfeat" if vlfeat else "popsift")
    dog = _dog(dev, seed=1)
    cand = extrema.collect_candidates(dog, cfg, 512)
    n = int(cand.n_found)
    assert n > 0
    args = (dog, cand.x0, cand.y0, cand.z0, n)
    got = refine.refine_state(*args, maxlevel=5, vlfeat=vlfeat)
    ref = refine.refine_state_torch(*args, maxlevel=5, vlfeat=vlfeat)
    assert torch.equal(got, ref)


def _keypoints(dev, L, H, W, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    return (f(rng.uniform(0, W - 1, n).astype(np.float32)),
            f(rng.uniform(0, H - 1, n).astype(np.float32)),
            f(rng.uniform(1.6, 5.1, n).astype(np.float32)),
            f(rng.integers(0, L, n).astype(np.int64)),
            f(rng.uniform(-math.pi, math.pi, n).astype(np.float32)),
            f(rng.random(n) < 0.9))


def test_orientation_kernel(dev):
    blur = torch.rand((6, 90, 120), device=dev) * 255
    x, y, s, lv, _, valid = _keypoints(dev, 6, 90, 120, 200, seed=2)
    got = orient.orientation_hist(blur, x, y, s, lv, valid, 180, 23)
    ref = orient.orientation_hist_torch(blur, x, y, s, lv, valid, 180, 23)
    assert torch.all(got[180:] == 0) and _rel_rows(got, ref)


def test_descriptor_kernel(dev):
    blur = torch.rand((6, 120, 150), device=dev) * 255
    x, y, s, lv, ang, valid = _keypoints(dev, 6, 120, 150, 160, seed=3)
    valid = torch.arange(160, device=dev) < 150
    got = desc.descriptor_loop(blur, x, y, s, lv, ang, valid, 150, 50)
    ref = desc.descriptor_loop_torch(blur, x, y, s, lv, ang, valid, 150, 50)
    assert torch.all(got[150:] == 0) and _rel_rows(got, ref)


@pytest.mark.parametrize("level", [1, 5])
def test_blur_dog_kernel(dev, level):
    """K5 on strided level planes of a [N, L, H, W] stack (the batched
    front's layout) equals its plain version bit for bit."""
    tables = build_gauss_tables(SiftConfig())
    k = full_kernel(tables.inc[level], int(tables.inc_span[level]))
    gen = torch.Generator(device="cpu").manual_seed(level)
    stack = (torch.rand((3, 4, 75, 131), generator=gen) * 255).to(dev)
    want = blur_dog.blur_dog_torch(stack[:, 1], k)
    before = blur_dog.launches
    got = blur_dog.blur_dog(stack[:, 1], k, out=(stack[:, 2], stack[:, 3]))
    torch.cuda.synchronize(dev)
    assert blur_dog.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_extrema_mask_batched_kernel(dev):
    dog = torch.cat([_dog(dev, seed=s) for s in (4, 5, 6)])
    before = extrema_mask.launches_batched
    got = extrema_mask.candidate_mask_batched(dog, 3, 2.72)
    assert extrema_mask.launches_batched == before + 1
    ref = extrema_mask.candidate_mask_batched_torch(dog, 3, 2.72)
    assert ref.sum() > 0 and torch.equal(got, ref)
    assert torch.equal(got[1], extrema_mask.candidate_mask(dog[5:10], 2.72))


@pytest.mark.parametrize("vlfeat", [False, True])
def test_refine_batched_kernel(dev, vlfeat):
    cfg = SiftConfig(sift_mode="vlfeat" if vlfeat else "popsift")
    dog = torch.cat([_dog(dev, seed=s) for s in (7, 8)])
    rset = extrema.collect_refined_batched(dog, 2, cfg, 512)
    assert int(rset.n_found.min()) > 0
    before = refine.launches_batched
    cap = 512
    rng = np.random.default_rng(0)
    z0 = torch.from_numpy(rng.integers(1, 5, 2 * cap)).to(dev)
    z0[::4] = 4                         # the frames' top DoG layer
    x0 = torch.from_numpy(rng.integers(4, 127, 2 * cap)).to(dev)
    y0 = torch.from_numpy(rng.integers(4, 93, 2 * cap)).to(dev)
    n_found = torch.tensor([cap, 300], device=dev)
    kw = dict(maxlevel=5, vlfeat=vlfeat)
    got = refine.refine_state_batched(dog, x0, y0, z0, n_found, 2, **kw)
    assert refine.launches_batched == before + 1
    ref = refine.refine_state_batched_torch(dog, x0, y0, z0, n_found, 2,
                                            **kw)
    assert torch.equal(got, ref)
