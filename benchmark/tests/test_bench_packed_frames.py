"""The reader of ``packed_frames_pct``: the share of the stretch's frames
whose ``get`` copied only the packed rows, on hand-set counters, and None
on a program without the ``frames.packed`` counter."""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace as NS

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness.spec import Cell, ROOT  # noqa: E402
from harness.trace import Trace  # noqa: E402
from test_bench_trace import profile  # noqa: E402

CELLS = ("video1080_stream", "video1080_batch4", "oxford_extract_stream")


@pytest.mark.parametrize("counters,want", [
    ({"frames": 8, "frames.packed": 8}, 100.0),
    ({"frames": 8, "frames.packed": 2}, 25.0),
    ({"frames": 8, "frames.packed": 0}, 0.0),
    ({"frames": 8}, None),                    # the parent's program
    ({"frames.packed": 4}, None),
    ({}, None),
])
def test_packed_frames_pct_on_hand_set_counters(monkeypatch, counters, want):
    from popsift_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    read = Cell("video1080_stream", ROOT).reader("packed_frames_pct")
    got = read(NS(trace=Trace(profile()), stretch_units=8))
    assert got == (pytest.approx(want) if want is not None else None)
    assert read(NS(trace=None, stretch_units=8)) is None


def test_packed_frames_pct_reads_none_on_a_program_without_counters(
        monkeypatch):
    from popsift_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")   # a program without any
    run = NS(trace=Trace(profile()), stretch_units=8)
    for name in CELLS:
        cell = Cell(name, ROOT)
        assert "packed_frames_pct" in [m["name"] for m in cell.per_layer]
        assert cell.reader("packed_frames_pct")(run) is None
    pair = Cell("oxford_pair_homography", ROOT)
    assert "packed_frames_pct" not in [m["name"] for m in pair.per_layer]
