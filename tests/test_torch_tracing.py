"""The port's spans and counters (``popsift_tpu_torch.utils.profiling``)
on the CPU: nothing recorded and nothing called while tracing is off;
request and parent ids while it is on; one zero-length begin and end
mark per stage of an extraction under ``torch.profiler``; and the
counters of one extraction against hand counts."""

import numpy as np
import pytest
import torch

from popsift_tpu_torch.api import PopSift
from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.ops.matching import match_descriptors
from popsift_tpu_torch.sfm.twoview import ransac_homography
from popsift_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

EXTRACT_STAGES = ("enqueue", "upload", "front", "detect", "orient", "desc",
                  "tail", "get", "check", "copy", "compact")


@pytest.fixture
def clean():
    P.enable_tracing(False)
    P.reset()
    yield
    P.enable_tracing(False)
    P.reset()


@pytest.fixture(scope="module")
def popsift(small_image):
    ps = PopSift(SiftConfig(), device="cpu")
    ps.enqueue(small_image).get()           # the plan and its constants
    return ps


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def test_off_records_nothing_and_calls_nothing(clean, popsift, small_image,
                                               monkeypatch):
    assert not P.tracing()
    assert P.span("front") is P.span("get", request=3) is P._OFF
    with P.span("enqueue") as s:
        assert s.request is None
    feats = popsift.enqueue(small_image).get()
    assert feats.getFeatureCount() > 0
    assert P.spans() == [] and P.counters() == {}

    def boom(*a, **k):
        raise AssertionError("a span that is off called out")
    for mod, name in ((torch.cuda.nvtx, "range_push"),
                      (torch.cuda.nvtx, "range_pop"), (P, "_Mark"),
                      (P, "_mark"), (P.time, "perf_counter_ns")):
        monkeypatch.setattr(mod, name, boom)
    for _ in range(3):
        with P.span("front"):
            P.count("host_syncs")
    monkeypatch.undo()
    # a span is on or off from where it is made: one made while off
    # leaves no mark in a profile that starts inside it
    off = P.span("front")
    with off:
        prof, _ = _profile(lambda: torch.ones(4).sum())
    assert not [e for e in prof.events() if e.name.startswith("popsift/")]
    assert P.spans() == []


def test_nested_spans_share_a_request_and_name_their_parent(clean):
    P.enable_tracing(True)
    with P.span("enqueue") as outer:
        with P.span("front") as inner:
            P.count("frames", 2)
        with P.span("detect") as nested:
            pass
    with P.span("enqueue") as other:
        P.count("frames")
    with P.span("get", request=outer.request) as later:
        P.count("host_syncs", 3)
    with P.span("load") as alone:
        pass
    recs = {r["id"]: r for r in P.spans()}
    first, front = recs[outer.id], recs[inner.id]
    assert front["request"] == first["request"] == inner.request \
        == outer.request == nested.request == later.request
    assert front["parent"] == recs[nested.id]["parent"] == outer.id
    assert first["parent"] is None and recs[other.id]["parent"] is None
    assert len({outer.request, other.request, alone.request}) == 3
    assert all(r["start_ns"] <= r["end_ns"] for r in recs.values())
    assert P.counters() == {"frames": 3, "host_syncs": 3}
    assert P.counters(outer.request) == {"frames": 2, "host_syncs": 3}
    assert P.counters(other.request) == {"frames": 1}
    table = P.summary().splitlines()
    assert table[0].split()[0] == "span"
    assert {line.split()[0] for line in table[1:6]} == {
        "enqueue", "front", "detect", "get", "load"}
    assert any(line.split()[:2] == ["host_syncs", "1"] for line in table)
    assert P._spans.maxlen == P.BUFFER
    P.reset()
    assert P.spans() == [] and P.counters() == {}


def _marks(prof) -> list:
    """The profile's ``popsift/`` events, checked to be marks that
    enclose nothing, in order."""
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    marks = [e for e in events if e.name.startswith(P.MARK_PREFIX)]
    for m in marks:
        assert not m.cpu_children, m.name
        inside = [e for e in events if e is not m and e.thread == m.thread
                  and m.time_range.start < e.time_range.start
                  < m.time_range.end]
        assert not inside, (m.name, [e.name for e in inside])
    return [m.name[len(P.MARK_PREFIX):] for m in marks]


def _pairs(names: list) -> dict:
    """Begin and end marks paired on a stack: name -> (depth, parent)."""
    stack, out = [], {}
    for n in names:
        if n.endswith("/end"):
            assert stack and stack[-1] == n[:-len("/end")], (n, stack)
            stack.pop()
        else:
            assert n not in out, n
            out[n] = (len(stack), stack[-1] if stack else None)
            stack.append(n)
    assert not stack
    return out


def test_one_extraction_leaves_a_mark_pair_per_stage(clean, popsift,
                                                     small_image):
    prof, feats = _profile(lambda: popsift.enqueue(small_image).get())
    names = _marks(prof)
    assert sorted(names) == sorted(
        list(EXTRACT_STAGES) + [s + "/end" for s in EXTRACT_STAGES])
    pairs = _pairs(names)
    assert pairs["enqueue"] == (0, None) and pairs["get"] == (0, None)
    for s in ("upload", "front", "detect", "orient", "desc", "tail"):
        assert pairs[s] == (1, "enqueue"), s
    for s in ("check", "copy", "compact"):
        assert pairs[s] == (1, "get"), s
    assert not P.tracing()
    recs = P.spans()
    assert len(recs) == len(EXTRACT_STAGES)
    assert len({r["request"] for r in recs}) == 1

    # the counters of the same extraction against hand counts
    job = popsift.enqueue(small_image)
    raw = job.raw
    c = P.counters()
    # two waits: the header of counts, then the kept rows' copies
    header = 2 * 8 + raw.octave_candidates.nbytes + raw.octave_dropped.nbytes
    kept = sum(getattr(feats, k).nbytes for k in (
        "x", "y", "sigma", "octave", "num_ori", "orientations", "ori_valid",
        "descriptors", "desc_to_kp"))
    assert c["host_syncs"] == 2
    assert c["d2h_bytes"] == header + kept
    assert 0 < c["d2h_bytes_kept"] <= c["d2h_bytes"]
    assert c["d2h_bytes_kept"] == kept
    assert c["frames.packed"] == 1
    assert c["rows_valid.desc"] == feats.getDescriptorCount() > 0
    assert c["rows_padded.desc"] == raw.desc.shape[0]
    assert c["frames"] == 1


def test_matching_mode_match_and_ransac(clean, small_image):
    ps = PopSift(SiftConfig(), mode="matching", device="cpu")
    P.enable_tracing(True)
    a = ps.enqueue(small_image).getDev()
    b = ps.enqueue(np.ascontiguousarray(small_image[:, ::-1])).getDev()
    assert P.counters()["host_syncs"] == 4           # two checks a job
    res = match_descriptors(a.raw.desc, a.raw.desc_valid, b.raw.desc,
                            b.raw.desc_valid)
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(16, 2, generator=g) * 60
    ransac_homography(g, pts, pts + 1.0, torch.ones(16, dtype=torch.bool),
                      n_hyp=8)
    P.enable_tracing(False)
    assert res.accept.shape[0] == a.raw.desc.shape[0]
    names = [r["name"] for r in P.spans()]
    assert names.count("get") == 2 and names.count("enqueue") == 2
    assert "copy" not in names
    assert names[-2:] == ["match", "ransac"]
    assert P.counters()["host_syncs"] == 4


def test_cpu_extraction_captures_no_graph(clean, popsift, small_image):
    """On the CPU every call runs the stages eagerly: no capture, no
    replayed frame, no ``graph`` span, and each call's stage spans and
    counters as the first call's."""
    P.enable_tracing(True)
    for _ in range(3):
        popsift.enqueue(small_image).get()
    P.enable_tracing(False)
    c = P.counters()
    assert "graph_captures" not in c and "frames.graph" not in c
    assert c["frames"] == 3
    plan = next(iter(popsift._plans.values()))
    assert plan._graphs == {}
    assert c["rows_padded.desc"] == 3 * sum(plan.job_caps)
    names = [r["name"] for r in P.spans()]
    assert "graph" not in names
    assert sorted(names) == sorted(3 * list(EXTRACT_STAGES))


@pytest.mark.parametrize("detect,front", [("fused", "level"),
                                          ("windows", "chain")])
def test_eager_stages_equal_extract_batch_on_the_cpu(small_image, detect,
                                                     front):
    """The stages after the upload, called alone on uploaded frames, give
    what ``extract_batch`` gives for the same frames."""
    from popsift_tpu_torch.pipeline import (_extract_frames,
                                            build_extract_plan,
                                            extract_batch)
    frames = np.stack([small_image, np.ascontiguousarray(small_image[::-1])])
    plan = build_extract_plan(SiftConfig(octaves=3), *small_image.shape)
    want = extract_batch(frames, plan, "cpu", detect=detect, front=front)
    got = _extract_frames(torch.from_numpy(frames), plan, False, detect,
                          front)
    assert int(want.n_keypoints.sum()) > 0
    for name, a, b in zip(want._fields, want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), name
