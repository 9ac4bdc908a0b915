"""The golden fixtures and the NumPy oracle on the card: the port against
the five fixtures of tests/golden, the port's copy of the oracle
(``popsift_tpu_torch/oracle/``) against the fixtures, the port against
that copy on scenes outside the fixtures, and the JAX package's
per-octave public names against ``extract`` on the bench frame.

These tests need a CUDA device (and nvcc, to build popsift_tpu_torch/csrc
on first use); they skip without one. On the card:

    python -m pytest tests/test_torch_oracle_cuda.py -q --noconftest -m cuda

Tolerances: those of tests/test_golden.py:21-24 (``GOLDEN_TOL``), and
against the oracle tests/test_pipeline.py:15-38's rule
(:func:`match_to_oracle`). The oracle runs on the host in
``ORACLE_WORKERS`` processes while the card runs the per-octave chain.
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.tools.kernel_times import synthetic_image
from torch_card import (BENCH_DESCRIPTORS, BENCH_KEYPOINTS, FRAME_HW,
                        GOLDEN_TOL, card_device, per_octave_chain)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scenes outside the five goldens, chosen before any run on the card:
# name -> ((h, w, seed) of synthetic_image, SiftConfig keywords, the
# oracle's descriptor variant)
ORACLE_SCENES = {
    "scene240_seed11_default": ((240, 320, 11), dict(octaves=5), "loop"),
    "scene240_seed5_default": ((240, 320, 5), dict(octaves=5), "loop"),
    "scene240_seed11_vlfeat_igrid": ((240, 320, 11), dict(
        octaves=5, sift_mode="vlfeat", desc_mode="igrid",
        norm_mode="classic"), "igrid")}
ORACLE_WORKERS = 4     # host processes running the oracle
GOLDEN_NAMES = ("scene64_default", "scene120_default", "scene64_vlfeat_igrid",
                "scene64_grid_fixed9", "scene64_iloop_interp")


def golden_cases() -> dict:
    """name -> (image, SiftConfig, the oracle's descriptor variant) of the
    five goldens of tests/golden (scripts/make_golden.py:28-55)."""
    s64 = synthetic_image(64, 80, seed=3)
    return {"scene64_default": (s64, SiftConfig(octaves=3), "loop"),
            "scene120_default": (synthetic_image(120, 160, seed=7),
                                 SiftConfig(octaves=4), "loop"),
            "scene64_vlfeat_igrid": (s64, SiftConfig(
                octaves=3, sift_mode="vlfeat", desc_mode="igrid",
                norm_mode="classic"), "igrid"),
            "scene64_grid_fixed9": (s64, SiftConfig(
                octaves=3, gauss_mode="fixed9", desc_mode="grid"), "grid"),
            "scene64_iloop_interp": (s64, SiftConfig(
                octaves=3, desc_mode="iloop",
                downscale_mode="interpolate"), "iloop")}


def oracle_cases() -> dict:
    cases = golden_cases()
    for name, ((h, w, seed), kw, variant) in ORACLE_SCENES.items():
        cases[name] = (synthetic_image(h, w, seed=seed), SiftConfig(**kw),
                       variant)
    return cases


def fixture(name: str):
    return np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))


@pytest.fixture(scope="module")
def dev():
    return card_device()


@pytest.fixture(scope="module")
def oracle(dev):
    """The oracle copy's ``oracle_extract`` of every case, running in
    ``ORACLE_WORKERS`` host processes: {name: future}, the largest scenes
    first."""
    from popsift_tpu_torch.oracle import oracle_extract
    with ProcessPoolExecutor(
            ORACLE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        yield {name: pool.submit(oracle_extract, img, cfg,
                                 desc_variant=variant)
               for name, (img, cfg, variant) in sorted(
                   oracle_cases().items(), key=lambda c: -c[1][0].size)}


def test_per_octave_chain_equals_extract(dev, oracle):
    """On the bench frame at ``SiftConfig(extrema_capacity=8192)`` (the
    oracle runs on the host meanwhile): every octave's rows of the
    per-octave chain against ``extract``'s rows of that octave, the
    keypoint masks, x, y and sigma (scaled to the input image), the
    orientation masks and the job masks exact, the angles and the
    descriptors within ``GOLDEN_TOL`` (the card runs the same kernel
    bodies, so they are expected bit-equal; the CPU's plain versions
    round exp and atan2 by where a row lies in the batch, and the peak
    fit turns a 1-ULP histogram change into up to 5e-5 rad); 2110 / 2505
    in all; ``make_extract_fn`` equal to ``extract`` in every field."""
    import bench

    from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                            make_extract_fn)
    frame = bench.make_frame(*FRAME_HW, seed=0)
    plan = build_extract_plan(SiftConfig(extrema_capacity=8192),
                              *frame.shape)
    uploaded = torch.from_numpy(frame).to(dev)
    feats = extract(uploaded, plan, dev)
    chain = per_octave_chain(uploaded, plan)
    ko = np.concatenate([[0], np.cumsum(plan.ext_caps)]).astype(int)
    jo = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)
    up = plan.config.upscale_factor
    n_kp = n_desc = 0
    ori_err = desc_err = 0.0
    for o, (ext, oris, jobs, desc) in enumerate(chain):
        k, j = slice(ko[o], ko[o + 1]), slice(jo[o], jo[o + 1])
        scale = 2.0 ** (o - up)
        for name, a, b in (
                ("valid", ext.valid, feats.valid[k]),
                ("x", ext.x * scale, feats.x[k]),
                ("y", ext.y * scale, feats.y[k]),
                ("sigma", ext.sigma * scale, feats.sigma[k]),
                ("ori_valid", oris.ori_valid, feats.ori_valid[k]),
                ("num_ori", oris.num_ori, feats.num_ori[k]),
                ("desc_valid", jobs.valid, feats.desc_valid[j])):
            assert torch.equal(a, b), (o, name)
        ori_err = max(ori_err, float((oris.ori - feats.ori[k]).abs().max()))
        n = int(jobs.count)
        if n:
            desc_err = max(desc_err, float((desc[:n] - feats.desc[j][:n])
                                           .abs().max()))
        n_kp += int((ext.valid & (oris.num_ori > 0)).sum())
        n_desc += n
    assert ori_err < GOLDEN_TOL["ori"] and desc_err < GOLDEN_TOL["desc"]
    assert (n_kp, n_desc) == (BENCH_KEYPOINTS, BENCH_DESCRIPTORS)
    for name, a, b in zip(feats._fields, make_extract_fn(plan, dev)(uploaded),
                          feats):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_port_against_the_golden_fixture(dev, name):
    """The port on the card against the fixture of tests/golden: the same
    keypoint and orientation counts, every field within
    ``GOLDEN_TOL``."""
    from popsift_tpu_torch.api import PopSift
    img, cfg, _ = golden_cases()[name]
    want = fixture(name)
    host = PopSift(cfg, device=dev).enqueue(img).get()
    feats = sorted(host.features(), key=lambda f: (
        round(f.x, 4), round(f.y, 4), round(f.sigma, 4)))
    got = dict(
        x=np.array([f.x for f in feats], np.float32),
        y=np.array([f.y for f in feats], np.float32),
        sigma=np.array([f.sigma for f in feats], np.float32),
        num_ori=np.array([f.num_ori for f in feats], np.int32),
        ori=np.concatenate([f.orientations[:f.num_ori] for f in feats]),
        desc=np.concatenate([f.descriptors for f in feats]))
    assert len(got["x"]) == len(want["x"])
    assert np.array_equal(got["num_ori"], want["num_ori"])
    for k, tol in GOLDEN_TOL.items():
        assert float(np.max(np.abs(got[k] - want[k]))) < tol, k


def oracle_flatten(feats) -> dict:
    """scripts/make_golden.py::flatten: the oracle's features sorted by
    (x, y, sigma), as the golden fixtures store them."""
    feats = sorted(feats, key=lambda f: (round(f.x, 4), round(f.y, 4),
                                         round(f.sigma, 4)))
    x = np.array([f.x for f in feats], np.float32)
    y = np.array([f.y for f in feats], np.float32)
    sigma = np.array([f.sigma for f in feats], np.float32)
    num_ori = np.array([len(f.orientations) for f in feats], np.int32)
    ori = np.concatenate([np.asarray(f.orientations, np.float32)
                          for f in feats]) if feats else np.zeros(0)
    desc = np.concatenate([np.stack(f.descriptors).astype(np.float32)
                           for f in feats]) if feats else np.zeros((0, 128))
    return dict(x=x, y=y, sigma=sigma, num_ori=num_ori, ori=ori, desc=desc)


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_oracle_copy_against_the_golden_fixture(oracle, name):
    """The oracle copy's ``oracle_extract`` against the fixture: the same
    keypoint and orientation counts, every field within
    ``GOLDEN_TOL``."""
    want = fixture(name)
    flat = oracle_flatten(oracle[name].result())
    assert len(flat["x"]) == len(want["x"])
    assert np.array_equal(flat["num_ori"], want["num_ori"])
    for k, tol in GOLDEN_TOL.items():
        assert float(np.max(np.abs(flat[k] - want[k]), initial=0.0)) < tol, k


def match_to_oracle(host, feats) -> None:
    """tests/test_pipeline.py:15-38's rule for the port's ``FeaturesHost``
    against the oracle's features: equal counts, a greedy 1-1 match of
    each keypoint to the nearest unused oracle keypoint within
    |dx| + |dy| < 5e-3 px, sigma within 1e-3, equal orientation counts and
    each descriptor within ``GOLDEN_TOL["desc"]``."""
    assert host.getFeatureCount() == len(feats)
    used = [False] * len(feats)
    for g in host.features():
        best, bi = None, -1
        for i, o in enumerate(feats):
            d = abs(g.x - o.x) + abs(g.y - o.y)
            if not used[i] and (best is None or d < best):
                best, bi = d, i
        assert best is not None and best < GOLDEN_TOL["x"], (g.x, g.y, best)
        used[bi] = True
        o = feats[bi]
        assert abs(g.sigma - o.sigma) < GOLDEN_TOL["sigma"], (g.x, g.y)
        assert g.num_ori == len(o.orientations), (g.x, g.y)
        dd = max((float(np.abs(g.descriptors[j] - o.descriptors[j]).max())
                  for j in range(g.num_ori)), default=0.0)
        assert dd < GOLDEN_TOL["desc"], (g.x, g.y, dd)


@pytest.mark.parametrize("name", list(ORACLE_SCENES))
def test_port_against_the_oracle_copy(dev, oracle, name):
    """``PopSift(cfg, device="cuda")`` on a 240 x 320 scene outside the
    fixtures against the oracle copy by :func:`match_to_oracle`."""
    from popsift_tpu_torch.api import PopSift
    img, cfg, _ = oracle_cases()[name]
    match_to_oracle(PopSift(cfg, device=dev).enqueue(img).get(),
                    oracle[name].result())
