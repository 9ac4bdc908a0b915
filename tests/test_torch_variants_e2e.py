"""The extraction variants of popsift_tpu_torch end to end on the CPU:
the variant cases of tests/test_variants.py run through the port and held
to the oracle there, every mode value (and the grid filter) through
``PopSift.enqueue`` and ``enqueue_batch``, and both routes under a
variant configuration. Pyramids and descriptors against JAX are in
tests/test_torch_variants.py, the grid filter in
tests/test_torch_gridfilter.py, the goldens in
tests/test_torch_golden_variants.py.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch.config import SiftConfig as PortSiftConfig
from popsift_tpu_torch.pipeline import build_extract_plan, extract
from test_torch_pipeline import port_config

torch.set_num_threads(1)


def test_all_desc_modes_run_end_to_end(small_image):
    """Port of test_variants.py::test_all_desc_modes_run_end_to_end."""
    counts = {}
    for mode in ("loop", "iloop", "grid", "igrid", "notile"):
        cfg = PortSiftConfig(octaves=2, extrema_capacity=128, desc_mode=mode)
        out = extract(small_image, build_extract_plan(cfg, *small_image.shape),
                      "cpu")
        counts[mode] = int(out.n_descriptors)
        assert counts[mode] > 0
    assert counts["igrid"] == counts["notile"]


def test_float_input_matches_uint8(small_image):
    """Port of test_variants.py::test_float_input_matches_uint8, under a
    variant configuration."""
    cfg = PortSiftConfig(octaves=3, extrema_capacity=256,
                         gauss_mode="fixed15", desc_mode="grid")
    plan = build_extract_plan(cfg, *small_image.shape)
    o1 = extract(small_image, plan, "cpu")
    o2 = extract(small_image.astype(np.float32) / 255.0, plan, "cpu")
    assert int(o1.n_keypoints) == int(o2.n_keypoints) > 0
    assert torch.allclose(o1.x, o2.x, atol=1e-3)
    assert torch.allclose(o1.desc, o2.desc, atol=2e-3)


def test_vlfeat_relative_end_to_end(small_image):
    """Port of test_variants.py::test_vlfeat_relative_end_to_end."""
    def n_kp(**kw):
        cfg = PortSiftConfig(octaves=3, extrema_capacity=256, **kw)
        return int(extract(small_image,
                           build_extract_plan(cfg, *small_image.shape),
                           "cpu").n_keypoints)
    n, nb = n_kp(gauss_mode="vlfeat-relative"), n_kp()
    assert n > 0 and abs(n - nb) <= max(2, nb // 3)


def test_saturation_warning(small_image):
    """Port of test_variants.py::test_saturation_warning."""
    ps = tapi.PopSift(PortSiftConfig(octaves=3, extrema_capacity=4,
                                     threshold=0.005, desc_mode="iloop"),
                      device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ps.enqueue(small_image).get()
    assert any("saturated" in str(r.message) for r in rec)


def test_calibrate_plan(small_image):
    """Port of test_variants.py::test_calibrate_plan and
    ::test_popsift_calibrate_api, under the modes that change the front."""
    cfg = PortSiftConfig(octaves=3, gauss_mode="fixed9",
                         downscale_mode="interpolate", desc_mode="igrid")
    ps = tapi.PopSift(cfg, device="cpu")
    plan = ps.calibrate([small_image])
    assert all(c >= 256 for c in plan.ext_caps)
    assert ps.enqueue(small_image).get().getFeatureCount() > 0


# every value of every mode, and the grid filter, through enqueue and
# enqueue_batch
MODES = {
    "gauss_vlfeat_relative": dict(gauss_mode="vlfeat-relative"),
    "gauss_relative_all": dict(gauss_mode="vlfeat-relative-all"),
    "gauss_opencv": dict(gauss_mode="opencv"),
    "gauss_fixed9": dict(gauss_mode="fixed9"),
    "gauss_fixed15": dict(gauss_mode="fixed15"),
    "sift_vlfeat": dict(sift_mode="vlfeat"),
    "sift_opencv": dict(sift_mode="opencv"),
    "desc_iloop": dict(desc_mode="iloop"),
    "desc_grid": dict(desc_mode="grid"),
    "desc_igrid": dict(desc_mode="igrid"),
    "desc_notile": dict(desc_mode="notile"),
    "interpolate": dict(downscale_mode="interpolate"),
    "direct": dict(scaling_mode="direct"),
    "grid_filter": dict(filter_max_extrema=8, grid_filter_mode="smallest"),
    "upscale0_classic": dict(upscale_factor=0.0, norm_mode="classic"),
}


@pytest.mark.parametrize("name", sorted(MODES))
def test_every_mode_through_enqueue_and_batch(name):
    """Two frames through ``enqueue_batch``, each equal to its own
    ``enqueue`` in every field, with keypoints and descriptors."""
    cfg = PortSiftConfig(octaves=3, extrema_capacity=64, **MODES[name])
    frames = [synthetic_image(48, 64, seed=s) for s in (3, 4)]
    ps = tapi.PopSift(cfg, device="cpu")
    batch = ps.enqueue_batch(frames)
    for f, img in enumerate(frames):
        single = ps.enqueue(img)
        assert single.get().getDescriptorCount() > 0
        for field, a, b in zip(single.raw._fields, batch[f].raw,
                               single.raw):
            assert torch.equal(a, b), (field, f)


@pytest.mark.parametrize("route", [dict(detect="windows"),
                                   dict(front="chain")],
                         ids=["windows", "chain"])
def test_routes_equal_under_variants(small_image, route):
    """The window route and the chain front give the default route's
    features under an interpolated, igrid, grid-filtered configuration."""
    cfg = PortSiftConfig(octaves=3, extrema_capacity=128,
                         downscale_mode="interpolate", desc_mode="igrid",
                         filter_max_extrema=4)
    want = tapi.PopSift(cfg, device="cpu").enqueue(small_image).raw
    got = tapi.PopSift(cfg, device="cpu", **route).enqueue(small_image).raw
    for field, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), field
    unfiltered = tapi.PopSift(cfg.replace(filter_max_extrema=-1),
                              device="cpu").enqueue(small_image).raw
    assert int(unfiltered.n_keypoints) > int(want.n_keypoints) > 0


def test_port_config_keeps_every_mode():
    """The tests build the port's config from the JAX one field by field."""
    for kw in MODES.values():
        cfg = SiftConfig(**kw)
        assert dataclasses.asdict(port_config(cfg)) == dataclasses.asdict(cfg)
