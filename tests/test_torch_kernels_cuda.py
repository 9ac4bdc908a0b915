"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests need a CUDA
device (and nvcc, to build popsift_tpu_torch/csrc on first use); they
skip without one. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances: masks and refinement state exact (the kernels are built with
-fmad=false and follow the plain version op for op); histograms and
descriptors within 1e-5 x the row's max (fixed-order sums in another
order than the plain version's reductions).
"""

import math

import numpy as np
import pytest
import torch

from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.ops import extrema
from popsift_tpu_torch.ops.kernels import (desc, extrema_mask, orient,
                                           refine)

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
