"""The BAL cell on the CPU: the reference's and the scene's copies equal
their originals in the program, the roofline arithmetic against a hand
count, the cell's readers on a program without its spans and counters,
and whole small runs of the cell: the program comes out correct, while
the bfloat16 control and planted faults (distortion dropped, the sign of
k2 flipped, one camera's update skipped) do not."""

from __future__ import annotations

import copy
import os
import sys
import time
from types import SimpleNamespace as NS

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from harness import ba_bounds, core  # noqa: E402
from harness.spec import Cell  # noqa: E402
from harness.trace import Trace  # noqa: E402
from test_bench_trace import ev, profile as no_marks  # noqa: E402

CELL = "bal_dubrovnik88_lm10"
METRICS = ("ba_roofline", "ba_coupling_fill_pct", "idle_ms.ba",
           "ba_launches_per_iter")


def _read(path: str) -> bytes:
    with open(os.path.join(ROOT, path), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("copy_, original", [
    ("benchmark/reference/bal.py", "popsift_tpu_torch/sfm/bal_reference.py"),
    ("benchmark/scenes/bal_scene.py", "popsift_tpu_torch/tools/bal_scene.py")])
def test_copies_equal_their_originals(copy_, original):
    assert _read(copy_) == _read(original)


def test_bound_against_a_hand_count():
    # two cameras, one point seen by both: 2 observations, 4 track pairs
    per_obs = 200 + 4 * (81 + 9 + 27 + 9 + 3) + 162 + 54 + 46   # 978
    ops = 2 * per_obs + (50 + 18) + 4 * 486 + 18 ** 3 / 3
    assert ba_bounds.iteration_ops(2, 1, 2, 4) == pytest.approx(ops)
    nbytes = 2 * 16 + 8 * (18 + 3) + 8 * 18 ** 2
    assert ba_bounds.iteration_bytes(2, 1, 2) == nbytes
    assert ba_bounds.ba_bound(2, 1, 2, 4, 10) == pytest.approx(
        10 * max(nbytes / 3.35e12, ops / 67e12))
    # Dubrovnik-88's counts: the f32 operations bound it
    assert ba_bounds.iteration_ops(88, 64298, 383937, 4_000_000) / 67e12 \
        > ba_bounds.iteration_bytes(88, 64298, 383937) / 3.35e12


def test_the_cell_reports_its_metrics():
    cell = Cell(CELL, ROOT)
    assert [m["name"] for m in cell.end_to_end] == ["request_ms_p95",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(METRICS)


def test_readers_find_nothing_on_a_program_without_marks(monkeypatch):
    cell = Cell(CELL, ROOT)
    run = NS(trace=Trace(no_marks()), stretch_units=3, work=None)
    from popsift_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")       # as on the parent
    for name in METRICS:
        assert cell.reader(name)(run) is None, name
    monkeypatch.setattr(profiling, "counters", lambda: {
        "ba.iters": 30, "ba.coupling_obs": 3 * 383937,
        "ba.coupling_blocks": 3 * 64298 * 88}, raising=False)
    assert cell.reader("ba_coupling_fill_pct")(run) == pytest.approx(
        100 * 383937 / (64298 * 88))
    assert cell.reader("ba_launches_per_iter")(run) == \
        pytest.approx(2 / 30)                          # two launch calls
    assert cell.reader("idle_ms.ba")(run) is None      # no program span


def test_roofline_reads_the_bench_ba_span():
    stretch = ev("bench/stretch", 0, 100)
    prof = NS(events=lambda: [
        stretch, ev("bench/ba", 10, 60, parent=stretch),
        ev("popsift/ba", 11, 11, parent=stretch),
        ev("popsift/ba/end", 59, 59, parent=stretch),
        ev("volta_sgemm", 20, 40, cuda=True),          # inside bench/ba
        ev("Memcpy DtoH (Device -> Pageable)", 70, 80, cuda=True)])
    run = NS(trace=Trace(prof), stretch_units=1,
             work=dict(ba=[(2, 1, 2, 4)], iters=10))
    cell = Cell(CELL, ROOT)
    bound = ba_bounds.ba_bound(2, 1, 2, 4, 10)
    assert cell.reader("ba_roofline")(run) == pytest.approx(
        100 * bound / 20e-6)
    # the device idles 10-20 and 40-59 of the program's span 11-59
    assert cell.reader("idle_ms.ba")(run) == pytest.approx(28e-3)


def small_cell() -> Cell:
    cell = Cell(CELL, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config["problem"] = {"cameras": 40, "points": 3000,
                              "observations": 15000}
    cell.traffic = dict(cell.traffic, pool=2)
    return cell


def run(cell: Cell, seconds: float = 0.2):
    torch.set_num_threads(2)
    return core.run_cell(cell, 2 ** 31 + 77, seconds, False,
                         torch.device("cpu"), time.perf_counter(),
                         lambda m: None)


def test_cell_is_correct_and_its_control_is_not():
    cell = small_cell()
    result, r = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"request_ms_p95", "setup_s"}
    assert set(result["checks"]) == set(cell.limits)
    ctl = cell.driver.control(r.state, r.records, torch.bfloat16)
    assert set(ctl) == set(cell.limits)
    assert any(v > cell.limits[k] for k, v in ctl.items()), ctl


def _faulty_projection(kind):
    from popsift_tpu_torch.sfm.rotation import exp_so3

    def project_bal(cam, X, intr=None):
        P = exp_so3(cam[:3]) @ X + cam[3:6]
        q = -P[:2] / P[2]
        r2 = torch.sum(q * q)
        if kind == "no_distortion":
            return cam[6] * q
        return cam[6] * (1.0 + cam[7] * r2 - cam[8] * r2 * r2) * q
    return project_bal


@pytest.mark.parametrize("fault", ["no_distortion", "k2_sign",
                                   "camera_skipped"])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    from popsift_tpu_torch.sfm import ba
    if fault == "camera_skipped":
        step = ba.schur_dense_step

        def skipping(*args, **kw):
            dc, dp, cost = step(*args, **kw)
            return dc.index_fill(0, dc.new_full((1,), 3, dtype=torch.long),
                                 0.0), dp, cost
        monkeypatch.setattr(ba, "schur_dense_step", skipping)
    else:
        monkeypatch.setattr(ba, "project_bal", _faulty_projection(fault))
    result, _ = run(small_cell())
    assert not result["correct"], result["checks"]
