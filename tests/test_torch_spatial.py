"""The port's spatial sharding (``parallel/spatial.py``) on gloo CPU ranks,
against the JAX package's ``parallel/spatial.py`` on ``make_mesh`` of the
conftest's virtual devices and against the port's single-device path; the
port of tests/test_spatial.py's five cases.

* the sharded pyramid, 8 ranks, 256 x 96: within 1e-4 of JAX's
  ``make_sharded_pyramid_fn`` (tests/test_spatial.py:34-35) and bit-equal
  to the port's single-device blur chain;
* both rejection cases (a height that does not divide, a band under the
  blur halo; direct scaling, a height that does not divide);
* the sharded extraction, 4 ranks, 224 x 160,
  ``SiftConfig(octaves=4, extrema_capacity=512)``: against JAX's
  ``make_sharded_extract_fn`` row for row (both lay the gathered arrays
  out the same way: counts and validity exact, keypoint fields 2e-4,
  descriptors 5e-3, tests/test_spatial.py:103-115), and against the
  port's single-device ``extract`` at the effective capacities as sets
  (counts exact, keypoints bit-equal, the largest gap of the
  orientations and descriptors printed and held to 1e-5);
* DP x SP on a (2, 2) mesh of the 4 ranks, two frames: each frame equal
  to its 2-rank sharded extraction and, as sets, to the port's
  single-device ``extract``; against JAX's
  ``make_batched_sharded_extract_fn`` in a ``slow`` test.

The ranks start once a job (``parallel/launch.py::spawn``; rank bodies
``tools/rank_cases.py::sharded_pyramid`` and ``sharded_extract``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.parallel.mesh import make_mesh
from popsift_tpu.parallel.spatial import (make_batched_sharded_extract_fn,
                                          make_sharded_extract_fn,
                                          make_sharded_pyramid_fn)
from popsift_tpu_torch.ops.kernels.blur_dog import blur_dog_torch
from popsift_tpu_torch.ops.pyramid import build_pyramid_plan
from popsift_tpu_torch.parallel.launch import spawn
from popsift_tpu_torch.pipeline import build_extract_plan, extract
from popsift_tpu_torch.tools import rank_cases
from test_torch_pipeline import port_config

pytestmark = pytest.mark.distributed
torch.set_num_threads(1)

H, W = 224, 160
CFG = SiftConfig(octaves=4, extrema_capacity=512)
PH, PW = 256, 96
INT_FIELDS = ("octave", "num_ori", "valid", "ori_valid", "desc_kp",
              "desc_valid", "n_keypoints", "n_descriptors",
              "octave_candidates", "octave_dropped")


@pytest.fixture(scope="module")
def inputs():
    lvl0 = np.random.default_rng(42).normal(96, 40, size=(PH, PW)).astype(
        np.float32)
    frame = synthetic_image(H, W, seed=11)
    frames = np.stack([synthetic_image(H, W, seed=20 + i) for i in range(2)])
    return lvl0, frame, frames


@pytest.fixture(scope="module")
def ranks8(inputs):
    return spawn(rank_cases.sharded_pyramid, 8, "gloo", "cpu",
                 args=(inputs[0], dataclasses.asdict(SiftConfig())),
                 timeout=240)


@pytest.fixture(scope="module")
def ranks4(inputs):
    return spawn(rank_cases.sharded_extract, 4, "gloo", "cpu",
                 args=(*inputs[1:], dataclasses.asdict(CFG)), timeout=240)


def test_sharded_pyramid_matches_single_device(ranks8, inputs):
    lvl0 = inputs[0]
    fn = make_sharded_pyramid_fn(SiftConfig(), PH, PW,
                                 make_mesh(8, axis_name="sp"))
    jblurs, jdogs = fn(jnp.asarray(lvl0))
    plan = build_pyramid_plan(port_config(SiftConfig()), PH, PW)
    levels, dogs = [torch.from_numpy(lvl0)], []
    for kernel in plan.inc_kernels[1:]:
        blur, dog = blur_dog_torch(levels[-1][None], kernel)
        levels.append(blur[0])
        dogs.append(dog[0])
    for r in ranks8:
        assert r["n"] == 8
        assert np.array_equal(r["blurs"], ranks8[0]["blurs"])
        assert np.array_equal(r["dogs"], ranks8[0]["dogs"])
    got = ranks8[0]
    assert np.array_equal(got["blurs"], torch.stack(levels).numpy())
    assert np.array_equal(got["dogs"], torch.stack(dogs).numpy())
    np.testing.assert_allclose(got["blurs"], np.asarray(jblurs), atol=1e-4)
    np.testing.assert_allclose(got["dogs"], np.asarray(jdogs), atol=1e-4)


def test_sharded_pyramid_rejects_bad_height(ranks8):
    assert all(r["rejects_height"] and r["rejects_band"] for r in ranks8)


def _assert_rows_match_jax(got: dict, ref) -> None:
    """Row for row: integer fields exact, keypoint fields 2e-4,
    descriptors 5e-3 (tests/test_spatial.py:103-115)."""
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    for name in INT_FIELDS:
        assert got[name].shape == ref[name].shape, name
        assert np.array_equal(got[name], ref[name]), name
    for name in ("x", "y", "sigma", "ori"):
        np.testing.assert_allclose(got[name], ref[name], atol=2e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got["desc"], ref["desc"], atol=5e-3)


def test_sharded_extract_matches_jax(ranks4, inputs):
    fn, eff = make_sharded_extract_fn(CFG, H, W, make_mesh(4, axis_name="sp"))
    ref = fn(jnp.asarray(inputs[1]))
    for r in ranks4:
        for name, v in r["feats"].items():
            assert np.array_equal(v, ranks4[0]["feats"][name]), name
    got = ranks4[0]
    assert tuple(got["eff"]) == tuple(eff)
    assert int(got["feats"]["n_keypoints"]) > 10
    _assert_rows_match_jax(got["feats"], ref)
    traffic = got["traffic"]
    assert traffic["exchange"] > 0 and traffic["gather"] == 4


def _sets(f: dict) -> tuple:
    """(sorted keypoint rows (x, y, sigma, num_ori), per keypoint the
    sorted orientations and descriptors) of a frame's features."""
    rows = np.nonzero(f["valid"])[0]
    kp = np.stack([f["x"][rows], f["y"][rows], f["sigma"][rows],
                   f["num_ori"][rows]], 1)
    order = np.lexsort(kp.T[::-1])
    per_kp = {}
    for d, k in zip(f["desc"][f["desc_valid"]], f["desc_kp"][f["desc_valid"]]):
        per_kp.setdefault((float(f["x"][k]), float(f["y"][k])), []).append(d)
    ori = {(float(f["x"][k]), float(f["y"][k])): np.sort(
        f["ori"][k][f["ori_valid"][k]]) for k in rows}
    return (kp[order], ori,
            {k: np.sort(np.stack(v), axis=0) for k, v in per_kp.items()})


def _assert_same_sets(got: dict, ref: dict, tag: str) -> None:
    assert int(got["n_keypoints"]) == int(ref["n_keypoints"]) > 10, tag
    assert int(got["n_descriptors"]) == int(ref["n_descriptors"]), tag
    kp_g, ori_g, desc_g = _sets(got)
    kp_r, ori_r, desc_r = _sets(ref)
    assert np.array_equal(kp_g, kp_r), tag
    assert ori_g.keys() == ori_r.keys() and desc_g.keys() == desc_r.keys()
    gap_o = max(float(np.abs(ori_g[k] - ori_r[k]).max(initial=0))
                for k in ori_g)
    gap_d = max(float(np.abs(desc_g[k] - desc_r[k]).max()) for k in desc_g)
    print(f"{tag}: keypoints bit-equal; largest gap: orientations "
          f"{gap_o:.3g}, descriptors {gap_d:.3g}")
    assert gap_o <= 1e-5 and gap_d <= 1e-5, tag


def _single(frame, eff) -> dict:
    plan = build_extract_plan(port_config(CFG), H, W, octave_caps=eff)
    return {k: v.numpy() for k, v in extract(frame, plan, "cpu")
            ._asdict().items()}


def test_sharded_extract_matches_single_device(ranks4, inputs):
    got = ranks4[0]
    _assert_same_sets(got["feats"], _single(inputs[1], tuple(got["eff"])),
                      "4 ranks")


def test_sharded_extract_rejects_unsupported(ranks4):
    assert all(r["rejects_direct"] and r["rejects_height"] for r in ranks4)


def test_batched_sharded_extract_2d_mesh(ranks4, inputs):
    frames = inputs[2]
    for r in ranks4:
        for name, v in r["batch"].items():
            assert np.array_equal(v, ranks4[0]["batch"][name]), name
    got = ranks4[0]
    eff = tuple(got["eff2"])
    for b in range(2):
        frame = {k: v[b] for k, v in got["batch"].items()}
        for name, v in frame.items():
            assert np.array_equal(v, got["alone"][name][b]), (b, name)
        _assert_same_sets(frame, _single(frames[b], eff), f"DP x SP frame {b}")


@pytest.mark.slow
def test_batched_sharded_extract_matches_jax(ranks4, inputs):
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = jax.sharding.Mesh(devs, ("dp", "sp"))
    fn, eff = make_batched_sharded_extract_fn(CFG, H, W, mesh)
    ref = fn(jnp.asarray(inputs[2]))
    got = ranks4[0]
    assert tuple(got["eff2"]) == tuple(eff)
    for b in range(2):
        _assert_rows_match_jax({k: v[b] for k, v in got["batch"].items()},
                               jax.tree.map(lambda a: a[b], ref))
