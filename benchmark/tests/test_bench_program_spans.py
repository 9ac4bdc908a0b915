"""The program's marks paired into spans, the device's idle time inside
their self intervals, and the readers of the program's spans and
counters: on a hand-made profile, on a program without marks or
counters, and on a real profile of one extraction on the CPU."""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace as NS

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness import program_spans as ps  # noqa: E402
from harness.spec import Cell, ROOT  # noqa: E402
from harness.trace import Trace  # noqa: E402
from test_bench_trace import ev, profile as no_marks  # noqa: E402

STAGES = ("front", "detect", "orient", "desc")


def profile():
    """A stretch [0, 100] us: ``enqueue`` [2, 40] with ``upload`` [3, 4],
    ``front`` [5, 20], ``detect`` [21, 30], ``orient`` [31, 33],
    ``desc`` [34, 38]; ``get`` [50, 95] with ``copy`` [53, 80] and
    ``compact`` [81, 90]; the device busy over [10, 25] and [70, 80]."""
    stretch = ev("bench/stretch", 0, 100)
    marks = []
    for name, a, b in (("enqueue", 2, 40), ("upload", 3, 4),
                       ("front", 5, 20), ("detect", 21, 30),
                       ("orient", 31, 33), ("desc", 34, 38),
                       ("get", 50, 95), ("copy", 53, 80),
                       ("compact", 81, 90)):
        marks += [ev("popsift/" + name, a, a, parent=stretch),
                  ev("popsift/" + name + "/end", b, b, parent=stretch)]
    return NS(events=lambda: [
        stretch, *marks,
        ev("popsift/orphan/end", 60, 60, parent=stretch),   # closes nothing
        ev("void at::native::vectorized_elementwise_kernel<4, Mul>(int)",
           10, 25, cuda=True),
        ev("Memcpy DtoH (Device -> Pageable)", 70, 80, cuda=True)])


def test_marks_pair_into_a_tree_and_self_intervals():
    t = Trace(profile())
    tree = ps.spans(t)
    assert [s["name"] for s in tree] == ["enqueue", "get"]
    assert [c["name"] for c in tree[0]["children"]] == [
        "upload", *STAGES]
    assert [c["name"] for c in tree[1]["children"]] == ["copy", "compact"]
    assert (tree[1]["start"], tree[1]["end"]) == (50, 95)
    assert ps.intervals(tree, ("enqueue",)) == [
        (2, 3), (4, 5), (20, 21), (30, 31), (33, 34), (38, 40)]
    assert ps.intervals(tree, ("get",), whole=True) == [(50, 95)]
    assert not any(lab.startswith("popsift/") for _, _, lab in t.device)
    # idle inside front [5, 20] less busy [10, 20]; detect [21, 30] less
    # [21, 25]; orient and desc all idle; get [50, 95] less [70, 80]
    run = NS(trace=t, stretch_units=1)
    want = {"front": 5e-3, "detect": 5e-3, "orient": 2e-3, "desc": 4e-3}
    for name, ms in want.items():
        assert ps.idle_ms_per_unit(run, (name,)) == pytest.approx(ms)
    assert ps.idle_ms_per_unit(run, ("get",), whole=True) == \
        pytest.approx(35e-3)
    # the five and the idle outside them make the stretch's idle
    ivals = ps.intervals(tree, STAGES) + ps.intervals(tree, ("get",), True)
    outside = ps.idle_s(t, ps.complement(t, ivals))
    total = t.window_s - t.busy_s
    assert outside + sum(want.values()) * 1e-3 + 35e-6 == \
        pytest.approx(total)


def test_readers_find_nothing_on_a_program_without_marks(monkeypatch):
    cell = Cell("video1080_stream", ROOT)
    pair = Cell("oxford_pair_homography", ROOT)
    run = NS(trace=Trace(no_marks()), stretch_units=2)
    names = [m["name"] for m in cell.per_layer if m["source"] in (
        "program_span", "program_counter")]
    assert len(names) == 8
    from popsift_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")       # as on the parent
    for name in names:
        assert cell.reader(name)(run) is None, name
    assert pair.reader("host_syncs_per_pair")(run) is None

    monkeypatch.setattr(profiling, "counters", lambda: {
        "host_syncs": 34, "d2h_bytes": 400, "d2h_bytes_kept": 20,
        "rows_padded.desc": 1000, "rows_valid.desc": 54}, raising=False)
    read = lambda name: cell.reader(name)(run)
    assert read("host_syncs_per_frame") == 17
    assert read("readback_kept_pct") == pytest.approx(5.0)
    assert read("desc_rows_valid_pct") == pytest.approx(5.4)
    assert pair.reader("host_syncs_per_pair")(run) == 17
    assert read("idle_ms.front") is None
    assert cell.reader("idle_ms.front")(NS(trace=Trace(profile()),
                                           stretch_units=1)) == \
        pytest.approx(5e-3)


def test_a_real_profile_of_one_extraction_on_the_cpu():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.utils import profiling

    rng = np.random.default_rng(0)
    img = (rng.random((48, 64)) * 255).astype(np.uint8)
    sift = PopSift(SiftConfig(octaves=2), device="cpu")
    sift.enqueue(img).get()
    profiling.reset()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench/stretch"):
            sift.enqueue(img).get()
    c = profiling.counters()
    profiling.reset()
    t = Trace(prof)
    tree = ps.spans(t)
    assert [s["name"] for s in tree] == ["enqueue", "get"]
    assert [x["name"] for x in tree[0]["children"]] == [
        "upload", *STAGES, "tail"]
    assert [x["name"] for x in tree[1]["children"]] == [
        "check", "copy", "compact"]
    assert c["host_syncs"] == 17 and c["frames"] == 1
    run = NS(trace=t, stretch_units=1)
    # no device here: the whole of each interval is idle
    ivals = ps.intervals(tree, STAGES) + ps.intervals(tree, ("get",), True)
    parts = [ps.idle_ms_per_unit(run, (n,)) for n in STAGES] + [
        ps.idle_ms_per_unit(run, ("get",), whole=True)]
    outside = ps.idle_s(t, ps.complement(t, ivals)) * 1e3
    assert sum(parts) + outside == pytest.approx(t.window_s * 1e3)
