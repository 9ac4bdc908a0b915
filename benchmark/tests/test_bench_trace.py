"""The trace arithmetic on a hand-made profile: the device's busy union,
the stretch, launches, device time by label and inside a span, the idle
gaps by host activity, and the readers built on them."""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness.spec import Cell, ROOT  # noqa: E402
from harness.trace import Trace, label  # noqa: E402


def ev(name, a, b, cuda=False, parent=None):
    return NS(name=name, time_range=NS(start=a, end=b), thread=1,
              device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
              cpu_parent=parent)


def profile():
    stretch = ev("bench/stretch", 0, 100)
    disp = ev("bench/dispatch", 0, 40, parent=stretch)
    mul = ev("aten::mul", 5, 30, parent=disp)
    launch = ev("cudaLaunchKernel", 6, 7, parent=mul)
    read = ev("bench/readback", 50, 100, parent=stretch)
    copy = ev("aten::to", 60, 90, parent=read)
    return NS(events=lambda: [
        stretch, disp, mul, launch, read, copy,
        ev("cudaLaunchKernel", 20, 21, parent=mul),
        ev("bench/dispatch", 0, 40, cuda=True),         # a span's mark
        ev("void at::native::vectorized_elementwise_kernel<4, Mul>(int)",
           10, 20, cuda=True),
        ev("void (anonymous namespace)::blur_dog_kernel<3>(float*)", 15, 25,
           cuda=True),
        ev("Memcpy DtoH (Device -> Pageable)", 70, 80, cuda=True)])


def test_busy_gaps_and_labels():
    t = Trace(profile())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(25e-6)          # [10, 25] and [70, 80]
    assert t.launches == 2
    assert t.device_s(["K5"]) == pytest.approx(10e-6)
    assert t.device_s() == pytest.approx(30e-6)
    assert t.device_s(inside="readback") == pytest.approx(10e-6)
    # gaps [0, 10], [25, 70] and [80, 100], each by what the host was
    # doing as it began
    assert dict(t.idle_gaps()) == pytest.approx({
        "dispatch: python": 10e-6, "dispatch: aten::mul": 45e-6,
        "readback: aten::to": 20e-6})
    assert label("void (anonymous namespace)::compact_kernel(int)") == \
        "compaction (compact_kernel)"
    assert label("void at::native::reduce_kernel<512, 1>(X)") == \
        "at::native::reduce_kernel"
    assert label("void at::native::(anonymous namespace)::cunn_Sort<4>()") \
        == "at::native::cunn_Sort"


def test_readers_on_the_hand_made_profile():
    cell = Cell("video1080_stream", ROOT)
    run = NS(trace=Trace(profile()), stretch_units=2, units={"frames": 30},
             window_s=0.5, request_s=[0.01] * 50 + [0.03] * 10,
             plain_s=[0.01] * 40 + [0.02] * 10,
             setup_s=7.0, layers={"readback": [0.004, 0.005, 0.006],
                                  "dispatch": [0.010]},
             work=None)
    read = lambda name: cell.reader(name)(run)
    assert read("frames_per_s") == pytest.approx(60.0)
    assert read("setup_s") == 7.0
    assert read("request_ms_p95") == pytest.approx(30.0)
    assert read("request_ms_p95.stream") == pytest.approx(20.0)
    assert read("readback_ms") == pytest.approx(5.0)
    assert read("launches_per_frame") == 1.0
    assert read("device_idle_pct") == pytest.approx(75.0)
    assert read("glue_device_ms") == pytest.approx(10e-3)
    assert read("front_roofline") is None             # no work recorded


def test_traced_run_alternates_layered_and_plain_requests():
    """After the profiled stretch every other request takes the untraced
    path; the stand-in for the window's tail reads only those."""
    import torch
    from harness import core
    calls = []

    def request(state, i, traced):
        calls.append((i, traced))
        rec = {"frames": [0]}
        if traced:
            rec["layers"] = {"dispatch": [1e-3]}
        return 1, rec

    drv = NS(UNIT="frames", prepare=lambda ctx, stamps: {},
             request=request, min_requests=lambda state: 16,
             release=lambda state, records: None,
             judge=lambda state, records, dtype: ({}, {}),
             work=lambda state, records: None)
    real = Cell("video1080_stream", ROOT)
    cell = NS(name="fake", root=ROOT, config={}, driver=drv, limits={},
              traffic={"trace_skip": 2, "trace_requests": 4},
              end_to_end=[], per_layer=[
                  m for m in real.per_layer
                  if m["name"] in ("request_ms_p95.stream", "dispatch_ms")],
              reader=real.reader)
    result, run = core.run_cell(cell, 1, 0.0, True, torch.device("cpu"),
                                0.0, lambda m: None)
    assert [i for i, t in calls if not t] == [7, 9, 11, 13, 15]
    assert len(run.plain_s) == 5 and len(run.layers["dispatch"]) == 7
    assert set(result["metrics"]) == {"request_ms_p95.stream", "dispatch_ms"}
