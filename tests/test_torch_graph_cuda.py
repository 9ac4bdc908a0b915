"""The extraction replayed as a CUDA graph against the eager stages, on
the card.

A CUDA graph exists only on a CUDA device, so these tests need one (and
nvcc, to build popsift_tpu_torch/csrc on first use); they skip without
one. On the card:

    python -m pytest tests/test_torch_graph_cuda.py -q --noconftest -m cuda

``extract_batch`` runs a key's first call eagerly and captures on the
second; the second and every later call replay. Every replay is held bit
for bit to
``pipeline._extract_frames`` (the eager stages) on the same uploaded
frames, in every field of ``SiftFeatures``: the 1080p configuration of
the benchmark at one and four frames on both detection routes, both
fronts and both input types, and the five golden scenes' configurations
and the card tests' variants on a smaller frame. Also: jobs held
open across later replays keep their own results, a replay makes no
stream synchronisation, a second frame size captures a graph of its own,
``configure`` drops the graphs, and the counters. An extracting job's
packed ``get`` from a replay equals the eager one bit for bit, its
arrays outlive later jobs on the plan, and matching mode packs nothing.
"""

import gc
import weakref
from functools import lru_cache

import numpy as np
import pytest
import torch

from popsift_tpu_torch import pipeline
from popsift_tpu_torch.api import PopSift
from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.utils import profiling as P
from torch_card import card_device

pytestmark = pytest.mark.cuda

# the benchmark's popsift_default_1080p (PopSift's defaults, no candidate
# dropped at 1080p)
CFG_1080 = SiftConfig(extrema_capacity=4096)
# scripts/make_golden.py's five scenes
GOLDEN = {
    "default": dict(octaves=3),
    "vlfeat_igrid": dict(octaves=3, sift_mode="vlfeat", desc_mode="igrid",
                         norm_mode="classic"),
    "default_4": dict(octaves=4),
    "grid_fixed9": dict(octaves=3, gauss_mode="fixed9", desc_mode="grid"),
    "iloop_interp": dict(octaves=3, desc_mode="iloop",
                         downscale_mode="interpolate"),
}
# test_torch_pipeline_cuda.VARIANTS beyond the golden ones (the grid
# filter at 100 extrema on this smaller frame)
VARIANTS = {
    "sift_opencv": dict(sift_mode="opencv"),
    "direct": dict(scaling_mode="direct"),
    "relative_all": dict(gauss_mode="vlfeat-relative-all"),
    "fixed15": dict(gauss_mode="fixed15"),
    "upscale0": dict(upscale_factor=0.0),
    "filter_largest": dict(filter_max_extrema=100, filter_grid_size=2,
                           grid_filter_mode="largest"),
    "filter_smallest": dict(filter_max_extrema=100, filter_grid_size=2,
                            grid_filter_mode="smallest"),
    "filter_random": dict(filter_max_extrema=100, filter_grid_size=2,
                          grid_filter_mode="random"),
}


@pytest.fixture
def dev():
    return card_device("a CUDA graph runs only on the card")


@pytest.fixture
def traced():
    P.reset()
    P.enable_tracing(True)
    yield
    P.enable_tracing(False)
    P.reset()


@lru_cache(maxsize=8)
def _frames(F: int, h: int, w: int, seed: int) -> np.ndarray:
    """F textured uint8 frames: blobs of many scales on smooth shading
    (each blob computed over its 4-sigma box). Read only."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(F):
        img = 96.0 + 40.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
        for _ in range(48):
            cx, cy = rng.uniform(0.05, 0.95, 2) * (w, h)
            s = rng.uniform(1.5, max(2.0, min(h, w) / 40.0))
            a = rng.uniform(40, 120) * rng.choice([-1.0, 1.0])
            y0, y1 = max(0, int(cy - 4 * s)), min(h, int(cy + 4 * s) + 1)
            x0, x1 = max(0, int(cx - 4 * s)), min(w, int(cx + 4 * s) + 1)
            img[y0:y1, x0:x1] += a * np.exp(
                -((xx[y0:y1, x0:x1] - cx) ** 2
                  + (yy[y0:y1, x0:x1] - cy) ** 2) / (2 * s * s))
        img += rng.normal(0, 2.0, size=(h, w)).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def _upload(frames: np.ndarray, dtype, dev) -> torch.Tensor:
    t = torch.from_numpy(frames).to(dev)
    return t if dtype == torch.uint8 else t.to(torch.float32) / 255.0


def _assert_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def _replays_bit_equal(cfg, h, w, F, dev, dtype=torch.uint8,
                       detect="fused", front="level"):
    """Three calls on frames A (eager, capture and replay, replay) and one
    on frames B (replay), each against the eager stages on its frames,
    and the counters of the four."""
    plan = pipeline.build_extract_plan(cfg, h, w)
    a = _upload(_frames(F, h, w, 1), dtype, dev)
    b = _upload(_frames(F, h, w, 2), dtype, dev)
    routes = dict(detect=detect, front=front)
    P.reset()
    got = [pipeline.extract_batch(a, plan, dev, **routes) for _ in range(3)]
    got_b = pipeline.extract_batch(b, plan, dev, **routes)
    c = P.counters()
    assert isinstance(plan._graphs[(F, dev, dtype, detect, front, False)],
                      pipeline._Graph)
    want = pipeline._extract_frames(a, plan, False, detect, front)
    want_b = pipeline._extract_frames(b, plan, False, detect, front)
    assert int(want.n_descriptors.sum()) > 0
    assert not torch.equal(want.desc, want_b.desc)
    for g in got:
        _assert_equal(g, want)
    _assert_equal(got_b, want_b)
    assert c["graph_captures"] == 1
    assert c["frames.graph"] == 3 * F
    assert c["frames"] == 4 * F
    assert c["rows_padded.desc"] == 4 * F * sum(plan.job_caps)


@pytest.mark.parametrize("F", [1, 4])
@pytest.mark.parametrize("detect,front", [("fused", "level"),
                                          ("fused", "chain"),
                                          ("windows", "level"),
                                          ("windows", "chain")])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_1080p_replay_is_bit_equal(dev, traced, F, detect, front, dtype):
    _replays_bit_equal(CFG_1080, 1080, 1920, F, dev, dtype, detect, front)


@pytest.mark.parametrize("name", list(GOLDEN) + list(VARIANTS))
def test_variant_replay_is_bit_equal(dev, traced, name):
    """Every variant captures: the plain-torch descriptor modes, the grid
    filter in its three orders, the scaling and downscale modes."""
    cfg = SiftConfig(**{**GOLDEN, **VARIANTS}[name])
    _replays_bit_equal(cfg, 240, 320, 1, dev)
    _replays_bit_equal(cfg, 240, 320, 2, dev, detect="windows",
                       front="chain")


@pytest.mark.parametrize("mode", ["extracting", "matching"])
def test_open_jobs_keep_their_own_results(dev, mode):
    """enqueue A, enqueue B, then ``get`` of A and of B: each equals its
    own eager result, though B's replay ran after A's."""
    frames = _frames(4, 480, 640, 3)
    ps = PopSift(SiftConfig(), mode=mode, device=dev)
    for k in range(2):                         # eager, then capture
        ps.enqueue(frames[k]).get()
        [j.get() for j in ps.enqueue_batch(frames[2 * k:2 * k + 2])]
    ja, jb = ps.enqueue(frames[2]), ps.enqueue(frames[3])
    jobs = ps.enqueue_batch(frames[:2]) + ps.enqueue_batch(frames[2:])
    plan = next(iter(ps._plans.values()))
    for F in (1, 2):
        assert isinstance(plan._graphs[(F, dev, torch.uint8, "fused",
                                        "level", mode == "extracting")],
                          pipeline._Graph)
    for job, k in zip([ja, jb] + jobs, [2, 3, 0, 1, 2, 3]):
        want = pipeline._extract_frames(_upload(frames[k:k + 1],
                                                torch.uint8, dev),
                                        plan, False, "fused", "level")
        want = pipeline.frame_features(want, 0)
        if mode == "matching":
            _assert_equal(job.get().raw, want)
        else:
            host = job.get()
            n = int(want.n_descriptors)
            assert host.getDescriptorCount() == n > 0
            keep = want.desc_valid.cpu().numpy()
            np.testing.assert_array_equal(host.descriptors,
                                          want.desc.cpu().numpy()[keep])


def test_replay_makes_no_sync(dev):
    """A replay of uploaded frames queues its copies and the graph's
    launch without one stream synchronisation."""
    plan = pipeline.build_extract_plan(SiftConfig(), 480, 640)
    up = _upload(_frames(2, 480, 640, 4), torch.uint8, dev)
    for _ in range(2):
        pipeline.extract_batch(up, plan, dev)
        pipeline.extract(up[0], plan, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        two = pipeline.extract_batch(up, plan, dev)
        one = pipeline.extract(up[0], plan, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len([g for g in plan._graphs.values()
                if isinstance(g, pipeline._Graph)]) == 2
    _assert_equal(two, pipeline._extract_frames(up, plan, False, "fused",
                                                "level"))
    _assert_equal(one, pipeline.frame_features(two, 0))


def test_each_frame_size_captures_its_own_graph(dev, traced):
    ps = PopSift(SiftConfig(), device=dev)
    small, large = _frames(1, 240, 320, 5)[0], _frames(1, 480, 640, 6)[0]
    for img in (small, small, small, large, large, large, small):
        ps.enqueue(img).get()
    c = P.counters()
    assert c["graph_captures"] == 2
    assert c["frames.graph"] == 5 and c["frames"] == 7
    assert {k[:2] for k in ps._plans} == {(240, 320), (480, 640)}
    for plan in ps._plans.values():
        assert [type(g) for g in plan._graphs.values()] == [pipeline._Graph]


@pytest.mark.parametrize("drop", ["configure", "uninit"])
def test_configure_drops_the_graphs(dev, traced, drop):
    ps = PopSift(SiftConfig(), device=dev)
    img = _frames(1, 240, 320, 7)[0]
    for _ in range(3):
        ps.enqueue(img).get()
    plan = next(iter(ps._plans.values()))
    graph = weakref.ref(next(iter(plan._graphs.values())))
    del plan
    if drop == "configure":
        ps.configure(SiftConfig(octaves=4))
    else:
        ps.uninit()
    gc.collect()
    assert ps._plans == {} and graph() is None
    ps.enqueue(img).get()                     # eager again, a new plan
    assert P.counters()["graph_captures"] == 1
    assert "frames.graph" in P.counters()
    plan = next(iter(ps._plans.values()))
    assert list(plan._graphs.values()) == [pipeline._SEEN]


def _host_arrays(host) -> dict:
    from popsift_tpu_torch.api import HOST_FIELDS
    return {k: getattr(host, k) for k in HOST_FIELDS}


def _assert_same_host(got: dict, want: dict):
    for k, b in want.items():
        a = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("cfg,h,w,F", [(CFG_1080, 1080, 1920, 1),
                                       (CFG_1080, 1080, 1920, 4)]
                         + [(SiftConfig(**GOLDEN[n]), 240, 320, 1)
                            for n in GOLDEN])
def test_packed_get_from_a_replay_equals_the_eager_one(dev, traced, cfg, h,
                                                       w, F):
    """The first call runs eagerly, the second captures the pack with the
    extraction, the third replays: each job's ``get`` equals the eager
    call's bit for bit and the NumPy compaction of its padded result,
    and a ``get`` makes two waits."""
    from popsift_tpu_torch.api import FeaturesHost
    frames = list(_frames(F, h, w, 8))
    ps = PopSift(cfg, device=dev)
    calls = []
    for k in range(3):
        jobs = ps.enqueue_batch(frames) if F > 1 else [ps.enqueue(frames[0])]
        P.reset()
        calls.append([_host_arrays(j.get()) for j in jobs])
        c = P.counters()
        assert c["host_syncs"] == 2 * F and c["frames.packed"] == F
        for j, got in zip(jobs, calls[-1]):
            _assert_same_host(got, _host_arrays(FeaturesHost(j.raw)))
    plan = next(iter(ps._plans.values()))
    g = plan._graphs[(F, dev, torch.uint8, "fused", "level", True)]
    assert isinstance(g.output[1], pipeline.Packed)
    assert sum(len(f["descriptors"]) for f in calls[0]) > 0
    for later in calls[1:]:
        for got, want in zip(later, calls[0]):
            _assert_same_host(got, want)


def test_packed_arrays_outlive_later_jobs(dev):
    """A job's ``FeaturesHost`` arrays are its own: 20 later
    ``enqueue(...).get()`` calls on the same plan leave them as they
    were."""
    frames = _frames(4, 480, 640, 9)
    ps = PopSift(SiftConfig(), device=dev)
    for k in range(2):                         # eager, then capture
        ps.enqueue(frames[k]).get()
    host = ps.enqueue(frames[0]).get()
    kept = {k: v.copy() for k, v in _host_arrays(host).items()}
    others = [ps.enqueue(frames[1 + k % 3]).get() for k in range(20)]
    assert all(o.getDescriptorCount() != host.getDescriptorCount()
               or not np.array_equal(o.descriptors, host.descriptors)
               for o in others)
    _assert_same_host(_host_arrays(host), kept)


def test_matching_mode_captures_no_pack(dev, traced):
    ps = PopSift(SiftConfig(), mode="matching", device=dev)
    img = _frames(1, 240, 320, 10)[0]
    for _ in range(3):
        ps.enqueue(img).get()
    plan = next(iter(ps._plans.values()))
    assert list(plan._graphs) == [(1, dev, torch.uint8, "fused", "level",
                                   False)]
    g = plan._graphs[list(plan._graphs)[0]]
    assert isinstance(g.output, pipeline.SiftFeatures)
    c = P.counters()
    assert "frames.packed" not in c and c["host_syncs"] == 6
