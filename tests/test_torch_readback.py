"""The packed readback of an extracting job against the NumPy compaction
of its padded result, on the CPU.

In extracting mode ``PopSift`` packs the rows ``FeaturesHost`` keeps on
the device (``pipeline.pack_kept``) and a job's ``get`` copies only
those; on the CPU the same pack runs eagerly. Each packed ``get`` is held
to ``FeaturesHost(job.raw)``, array for array (values, dtypes and shapes
of every field, ``desc_to_kp`` included): the five golden scenes, a
frame with no keypoint, keypoints with no orientation, each job of a
batch, and plans whose capacity saturates or whose compaction drops
candidates, which warn with the same texts. ``pack_kept`` is also held
to the NumPy compaction on random masks, and ``profiling.queue_to_host``
copies into memory of its own.
"""

import warnings

import numpy as np
import pytest
import torch

from popsift_tpu_torch import api, pipeline
from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.utils import profiling as P
from test_golden import _load_cases
from test_torch_pipeline import port_config

torch.set_num_threads(1)
GOLDEN = ("scene64_default", "scene120_default", "scene64_vlfeat_igrid",
          "scene64_grid_fixed9", "scene64_iloop_interp")


@pytest.fixture
def traced():
    P.reset()
    P.enable_tracing(True)
    yield
    P.enable_tracing(False)
    P.reset()


def _assert_same(got: api.FeaturesHost, want: api.FeaturesHost):
    for k in api.HOST_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def _packed_and_numpy(job: api.SiftJob):
    """The job's ``get`` (the packed path, checked by its counter) and
    the NumPy compaction of its padded result."""
    before = P.counters().get("frames.packed", 0)
    got = job.get()
    assert P.counters().get("frames.packed", 0) == before + 1
    return got, api.FeaturesHost(job.raw)


@pytest.mark.parametrize("name", GOLDEN)
def test_packed_get_equals_the_numpy_compaction(traced, name):
    img, cfg, _ = _load_cases()[name]
    job = api.PopSift(port_config(cfg), device="cpu").enqueue(img)
    got, want = _packed_and_numpy(job)
    assert got.getFeatureCount() > 0 and got.getDescriptorCount() > 0
    _assert_same(got, want)


def test_a_frame_without_keypoints(traced):
    job = api.PopSift(SiftConfig(), device="cpu").enqueue(
        np.full((64, 80), 128, np.uint8))
    got, want = _packed_and_numpy(job)
    assert got.getFeatureCount() == got.getDescriptorCount() == 0
    assert got.orientations.shape == (0, 4)
    assert got.descriptors.shape == (0, 128)
    _assert_same(got, want)


def test_keypoints_without_an_orientation(traced, small_image,
                                          monkeypatch):
    """Every other valid keypoint loses its orientations before the pack
    (in place, so the padded result shows it too): those rows are not
    kept, and their descriptors map to -1."""
    pack = pipeline.pack_kept

    def drop_some(feats):
        rows = torch.nonzero(feats.valid[0]).view(-1)[::2]
        feats.num_ori[0, rows] = 0
        return pack(feats)
    monkeypatch.setattr(pipeline, "pack_kept", drop_some)
    job = api.PopSift(SiftConfig(), device="cpu").enqueue(small_image)
    got, want = _packed_and_numpy(job)
    n_valid = int(job.raw.valid.sum())
    assert 0 < got.getFeatureCount() == n_valid - (n_valid + 1) // 2
    assert (got.desc_to_kp == -1).any() and (got.desc_to_kp >= 0).any()
    _assert_same(got, want)


def test_each_job_of_a_batch(traced, small_image):
    frames = [small_image, np.ascontiguousarray(small_image[::-1]),
              np.ascontiguousarray(small_image[:, ::-1])]
    ps = api.PopSift(SiftConfig(), device="cpu")
    jobs = ps.enqueue_batch(frames)
    for job, img in zip(jobs, frames):
        got, want = _packed_and_numpy(job)
        assert got.getDescriptorCount() > 0
        _assert_same(got, want)
        _assert_same(got, ps.enqueue(img).get())
    assert P.counters()["frames.packed"] == 6


def _warned(fn) -> tuple:
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    assert all(w.category is RuntimeWarning for w in rec)
    return out, [str(w.message) for w in rec]


@pytest.mark.parametrize("cfg,text", [
    (dict(extrema_capacity=2), "saturated at capacity"),
    (dict(extrema_capacity=64, compact_block_k=1),
     "dropped by the per-block density clamp"),
])
def test_saturated_plans_warn_as_before(traced, small_image, cfg, text):
    ps = api.PopSift(SiftConfig(octaves=3, **cfg), device="cpu")
    job = ps.enqueue(small_image)
    got, msgs = _warned(job.get)
    plan = next(iter(ps._plans.values()))
    want, want_msgs = _warned(api.SiftJob(job.raw, plan).get)
    assert msgs == want_msgs and any(text in m for m in msgs)
    assert P.counters()["frames.packed"] == 1
    _assert_same(got, want)
    _, again = _warned(job.get)                   # once a job
    assert again == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_kept_on_random_masks(seed):
    """Frame 0 keeps nothing, frame 1 everything, the others at random;
    descriptor rows point at any keypoint row."""
    g = torch.Generator().manual_seed(seed)
    F, K, J, n_oct = 4, 37, 45, 3
    valid = torch.rand(F, K, generator=g) < 0.6
    num_ori = torch.randint(0, 3, (F, K), generator=g)
    desc_valid = torch.rand(F, J, generator=g) < 0.5
    valid[0], valid[1], num_ori[1] = False, True, 1
    desc_valid[0], desc_valid[1] = False, True
    feats = pipeline.SiftFeatures(
        x=torch.rand(F, K, generator=g), y=torch.rand(F, K, generator=g),
        sigma=torch.rand(F, K, generator=g),
        octave=torch.randint(0, n_oct, (F, K), generator=g),
        num_ori=num_ori, valid=valid,
        ori=torch.rand(F, K, 4, generator=g),
        ori_valid=torch.rand(F, K, 4, generator=g) < 0.5,
        desc=torch.rand(F, J, 128, generator=g),
        desc_kp=torch.randint(0, K, (F, J), generator=g),
        desc_valid=desc_valid, n_keypoints=valid.sum(1),
        n_descriptors=desc_valid.sum(1),
        octave_candidates=torch.randint(0, 9, (F, n_oct), generator=g),
        octave_dropped=torch.randint(0, 9, (F, n_oct), generator=g))
    packed = pipeline.pack_kept(feats)
    for f in range(F):
        want = api._compact({k: v.numpy() for k, v in
                             pipeline.frame_features(feats, f)._asdict()
                             .items()})
        head = packed.header[f].numpy()
        n_kp, n_desc = len(want["x"]), len(want["descriptors"])
        assert head.tolist() == [n_kp, n_desc] + \
            feats.octave_candidates[f].tolist() + \
            feats.octave_dropped[f].tolist()
        end = pipeline.packed_offsets(n_kp, n_desc)[1]
        assert end == sum(a.nbytes for a in want.values())
        got = pipeline.unpack_kept(packed.data[f, :end].numpy().copy(),
                                   n_kp, n_desc)
        assert sorted(got) == sorted(api.HOST_FIELDS)
        for k, a in got.items():
            assert a.dtype == want[k].dtype and a.shape == want[k].shape, k
            assert np.array_equal(a, want[k]), k
    assert packed.header[0, :2].tolist() == [0, 0]
    assert packed.header[1, :2].tolist() == [K, J]


def test_queue_to_host_copies_into_memory_of_its_own(traced):
    """Every dtype and shape of the packed fields, empty ones too: equal
    copies that share no memory with their sources, their bytes
    counted."""
    src = [torch.arange(5, dtype=torch.float32),
           torch.ones(3, 4, dtype=torch.bool),
           torch.arange(7, dtype=torch.int64), torch.zeros(0, 128),
           torch.arange(256, dtype=torch.uint8)[3:40]]
    out = [P.queue_to_host(t) for t in src]
    P.wait(None)
    for s, o in zip(src, out):
        assert o.dtype == s.dtype and o.shape == s.shape and torch.equal(o, s)
        assert o.data_ptr() != s.data_ptr() or s.numel() == 0
    src[0].add_(1)
    assert torch.equal(out[0], torch.arange(5, dtype=torch.float32))
    assert P.counters() == {"d2h_bytes": sum(s.nbytes for s in src),
                            "host_syncs": 1}
