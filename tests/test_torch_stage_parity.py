"""The port's stages after the pyramid, fed the JAX package's own pyramid
planes, against the JAX pipeline on the same frame, on the CPU.

End to end, the port's CPU pyramid rounds differently from XLA's (XLA
contracts some shift-add terms; ROADMAP C "Pyramid, CPU"), and on noisy
frames that moves keypoints past the golden tolerances. Here
``popsift_tpu_torch.pipeline.build_pyramid_frames`` is replaced by one
that returns JAX's planes, so every remaining difference is the stages'
own: detection, refinement, orientation, descriptors and the output
tail. JAX's features and planes come from one jitted program
(``popsift_tpu.pipeline.extract`` beside ``build_pyramid``, which XLA
computes once for both), so the planes are the ones its features were
made from. Counts are held exactly and every feature field (x, y, sigma,
orientations, descriptors) within 1e-5.

Frames: a 240 x 320 crop of ``bench.make_frame(1080, 1920, seed=0)``
(70 keypoints; end to end, with its own pyramid, the port is 9.3e-4 px
off JAX in x and 5.3e-4 in sigma), and a noisy frame 150 wide and 48
high as ROADMAP C describes it (128 + 60 sin(x/5 + 3) cos(y/7), twelve
hard-edged disks of radius 2-8 and amplitude up to +-80, N(0, 12) noise,
``default_rng(3)``; 22 keypoints, end to end 7.5e-4 px in x, 2.5e-4 in
sigma, 1.7e-4 rad in orientation).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from popsift_tpu.api import FeaturesHost
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.pyramid import build_pyramid
from popsift_tpu.pipeline import build_extract_plan, extract
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch import pipeline as tpipe
from test_golden import _flatten_host
from test_torch_pipeline import port_config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402  (numpy-only frame generator at the repo root)

torch.set_num_threads(1)
TOL = 1e-5


def noisy_frame(h=48, w=150, seed=3):
    """ROADMAP C's noisy frame, 150 wide and 48 high, rebuilt from its
    description."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 128 + 60 * np.sin(xx / 5 + 3) * np.cos(yy / 7)
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(2, 8)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += \
            rng.uniform(-80, 80)
    img += rng.normal(0, 12, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


FRAMES = {
    "bench_crop": lambda: bench.make_frame(1080, 1920, seed=0)[:240, :320],
    "noisy_150x48": noisy_frame,
}


@pytest.mark.parametrize("name", FRAMES)
def test_stages_on_jax_planes_match_jax(name, monkeypatch):
    img = np.ascontiguousarray(FRAMES[name]())
    cfg = SiftConfig()
    plan = build_extract_plan(cfg, *img.shape)
    feats, (jb, jd) = jax.jit(lambda x: (
        extract(x, plan), build_pyramid(x, plan.pyramid)))(img)
    planes = ([torch.from_numpy(np.array(b))[None] for b in jb],
              [torch.from_numpy(np.array(d))[None] for d in jd])

    def jax_planes(imgs, plan, plain=False, front="level"):
        assert imgs.shape[0] == 1 and len(plan.dims) == len(planes[0])
        return planes

    monkeypatch.setattr(tpipe, "build_pyramid_frames", jax_planes)
    port = tapi.PopSift(port_config(cfg), device="cpu").enqueue(img).get()
    want_host = FeaturesHost(feats)
    assert port.getFeatureCount() == want_host.getFeatureCount() > 0
    assert port.getDescriptorCount() == want_host.getDescriptorCount()
    got, want = _flatten_host(port), _flatten_host(want_host)
    assert np.array_equal(got["num_ori"], want["num_ori"])
    for field in ("x", "y", "sigma", "ori", "desc"):
        assert got[field].shape == want[field].shape, field
        err = float(np.max(np.abs(got[field] - want[field])))
        assert err < TOL, (field, err)
