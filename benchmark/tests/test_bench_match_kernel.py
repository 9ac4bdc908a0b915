"""The reader of ``match_kernel_pct``: the share of the stretch's exact
matches that launched the matcher kernel, on hand-set counters, and None
on a program without the ``match.calls`` counter."""

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

OTHER_CELLS = ("video1080_stream", "video1080_batch4",
               "oxford_extract_stream", "bal_dubrovnik88_lm10")


@pytest.mark.parametrize("counters,want", [
    ({"match.calls": 8, "match.kernel": 8}, 100.0),
    ({"match.calls": 8, "match.kernel": 2}, 25.0),
    ({"match.calls": 8, "match.kernel": 0}, 0.0),
    ({"match.calls": 8}, 0.0),
    ({"match.kernel": 4}, None),                # no call counted
    ({"host_syncs": 4}, None),                  # the parent's program
    ({}, None),
])
def test_match_kernel_pct_on_hand_set_counters(monkeypatch, counters, want):
    from popsift_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    read = Cell("oxford_pair_homography", ROOT).reader("match_kernel_pct")
    got = read(NS(trace=Trace(profile()), stretch_units=8))
    assert got == (pytest.approx(want) if want is not None else None)
    assert read(NS(trace=None, stretch_units=8)) is None


def test_match_kernel_pct_reads_none_on_a_program_without_counters(
        monkeypatch):
    from popsift_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")   # a program without any
    run = NS(trace=Trace(profile()), stretch_units=8)
    pair = Cell("oxford_pair_homography", ROOT)
    assert "match_kernel_pct" in [m["name"] for m in pair.per_layer]
    assert pair.reader("match_kernel_pct")(run) is None
    for name in OTHER_CELLS:
        cell = Cell(name, ROOT)
        assert "match_kernel_pct" not in [m["name"] for m in cell.per_layer]
