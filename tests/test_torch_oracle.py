"""The port's copy of the NumPy SIFT oracle (``popsift_tpu_torch/oracle/``).

* the sanity and invariance tests of tests/test_oracle.py, run against
  the copy with the port's ``SiftConfig`` (its slow end-to-end test kept
  ``slow``);
* on the five golden cases (scripts/make_golden.py:28-55) the copy's
  ``oracle_extract``, flattened as ``make_golden.flatten`` does, equals
  the original's and the stored fixture bit for bit;
* importing the copy loads no torch and nothing of the JAX package.

tests/test_torch_imports.py holds the copy's source to the original's,
class for class and function for function.
"""

import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from popsift_tpu.oracle import oracle_extract as joracle_extract
from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.oracle import (
    oracle_descriptor_grid,
    oracle_extract,
    oracle_extrema,
    oracle_orientations,
    oracle_pyramid,
)
from popsift_tpu_torch.oracle.sift_oracle import (OracleExtremum,
                                                  normalize_descriptor)
from test_torch_pipeline import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SiftConfig(octaves=3)


def _make_golden():
    spec = importlib.util.spec_from_file_location(
        "_make_golden", os.path.join(REPO, "scripts", "make_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE_GOLDEN = _make_golden()
GOLDEN_CASES = MAKE_GOLDEN.golden_cases()


def blob_image(h, w, cx, cy, s, amp=200.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_pyramid_shapes(small_image):
    blurs, dogs = oracle_pyramid(small_image, CFG)
    assert len(blurs) == 3
    assert blurs[0].shape == (6, 128, 160)
    assert blurs[1].shape == (6, 64, 80)
    assert dogs[0].shape == (5, 128, 160)


def test_pyramid_mean_preserved(small_image):
    """Gaussian blur preserves the mean away from borders."""
    blurs, _ = oracle_pyramid(small_image, CFG)
    b = blurs[0]
    inner = (slice(20, -20), slice(20, -20))
    m0 = b[0][inner].mean()
    m5 = b[5][inner].mean()
    assert abs(m0 - m5) / m0 < 0.02


def test_pyramid_scale_is_255(small_image):
    """Pyramid values are in 0..255 scale (out*255, s_pyramid_build_ra.cu:54)."""
    blurs, _ = oracle_pyramid(small_image, CFG)
    assert blurs[0].max() > 10.0
    assert blurs[0].max() <= 256.0


def test_blob_detected_at_right_scale_and_position():
    """A Gaussian blob of scale s must yield a DoG extremum near (cx, cy)
    with sigma ~ s (Lindeberg scale selection)."""
    img = blob_image(96, 96, 48.0, 40.0, 3.0)
    cfg = SiftConfig(octaves=3)
    blurs, dogs = oracle_pyramid(img, cfg)
    found = []
    for octv, dog in enumerate(dogs):
        for e in oracle_extrema(dog, cfg, octv):
            scale = 2.0 ** (octv - cfg.upscale_factor)
            found.append((e.x * scale, e.y * scale, e.sigma * scale))
    assert found, "no extrema on an ideal blob"
    best = min(found, key=lambda f: (f[0] - 48) ** 2 + (f[1] - 40) ** 2)
    assert abs(best[0] - 48.0) < 1.0
    assert abs(best[1] - 40.0) < 1.0
    # DoG scale selection for an ideal blob peaks near sigma = s
    assert 1.5 < best[2] < 4.5


def test_orientation_of_gradient_step():
    """A vertical intensity ramp has gradient pointing +x: dominant
    orientation ~ 0 rad (or pi, depending on ramp sign)."""
    h = w = 96
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(xx * 2.0, 0, 255).astype(np.uint8)
    cfg = SiftConfig(octaves=2)
    blurs, _ = oracle_pyramid(img, cfg)
    e = OracleExtremum(octave=0, x=96.0, y=96.0, s=1.0, level=1, sigma=2.0)
    angs = oracle_orientations(blurs[0], e, cfg)
    assert angs
    # dominant angle along +x
    assert min(abs(angs[0]), abs(abs(angs[0]) - 2 * math.pi)) < 0.15


def test_descriptor_rotation_covariance():
    """The descriptor of a textured patch is nonnegative and nonzero
    before normalization (tests/test_oracle.py:95-109)."""
    rng_ = np.random.default_rng(0)
    h = w = 128
    img = np.clip(128 + 60 * rng_.standard_normal((h, w)), 0,
                  255).astype(np.uint8)
    cfg = SiftConfig(octaves=1)
    blurs, _ = oracle_pyramid(img, cfg)
    e = OracleExtremum(octave=0, x=128.0, y=128.0, s=1.0, level=1, sigma=1.9)
    d0 = oracle_descriptor_grid(blurs[0], e, 0.0, cfg)
    assert np.all(d0 >= 0)
    assert d0.sum() > 0


def test_rootsift_normalization_identity():
    d = np.abs(np.random.default_rng(1).standard_normal(128)).astype(
        np.float32)
    n = normalize_descriptor(d, SiftConfig())
    # RootSift: sum of squares == 1 (sqrt of L1-normalized)
    assert abs(float((n * n).sum()) - 1.0) < 1e-5


def test_classic_normalization():
    d = np.abs(np.random.default_rng(2).standard_normal(128)).astype(
        np.float32)
    n = normalize_descriptor(d, SiftConfig(norm_mode="classic"))
    assert abs(float(np.linalg.norm(n)) - 1.0) < 1e-4


@pytest.mark.slow
def test_end_to_end_extract(small_image):
    cfg = SiftConfig(octaves=3)
    feats = oracle_extract(small_image, cfg)
    assert len(feats) > 3
    for f in feats:
        assert 0 <= f.x < small_image.shape[1]
        assert 0 <= f.y < small_image.shape[0]
        assert len(f.descriptors) == len(f.orientations) > 0
        for d in f.descriptors:
            assert d.shape == (128,)
            assert abs(float((d * d).sum()) - 1.0) < 1e-4


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_copy_reproduces_the_golden_bit_for_bit(name):
    img, jcfg, variant = GOLDEN_CASES[name]
    got = MAKE_GOLDEN.flatten(oracle_extract(img, port_config(jcfg),
                                             desc_variant=variant))
    orig = MAKE_GOLDEN.flatten(joracle_extract(img, jcfg,
                                               desc_variant=variant))
    want = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
    assert sorted(got) == sorted(orig) == sorted(want.files)
    assert len(got["x"]) > 0
    for k in want.files:
        assert got[k].dtype == orig[k].dtype, k
        assert np.array_equal(got[k], orig[k]), k
        assert np.array_equal(got[k], want[k]), k


def test_copy_imports_no_torch():
    code = ("import sys; import popsift_tpu_torch.oracle; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'popsift_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
