"""Whole runs of each cell on the CPU at a small frame size, past the
harness's look for a card: the drivers and the reference agree with the
program (``correct`` true), while the control and the faults a cell can
have (an answer altered where it is produced, half of a batch left out)
come out not correct."""

from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from harness import core  # noqa: E402
from harness.spec import Cell  # noqa: E402

SMALL = {"popsift_default_1080p": (96, 128), "oxford_graf_800x640": (120, 160)}


def small_cell(name: str) -> Cell:
    cell = Cell(name, ROOT)
    cell.config = copy.deepcopy(cell.config)
    h, w = SMALL[cell.config["name"]]
    cell.config["frame"] = {"height": h, "width": w}
    if cell.config["scene"]["kind"] == "graf_pair":
        cell.config["scene"]["blobs"] = 96
    return cell


def run(cell: Cell, seconds: float = 0.5):
    torch.set_num_threads(2)
    return core.run_cell(cell, 2 ** 31 + 77, seconds, False,
                         torch.device("cpu"), time.perf_counter(),
                         lambda m: None)


@pytest.mark.parametrize("name", ["video1080_stream", "video1080_batch4",
                                  "oxford_extract_stream",
                                  "oxford_pair_homography"])
def test_cell_is_correct_and_its_control_is_not(name):
    cell = small_cell(name)
    result, r = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    for m in cell.end_to_end:
        assert m["name"] in result["metrics"]
    ctl = cell.driver.control(r.state, r.records, torch.bfloat16)
    assert set(ctl) <= set(cell.limits)
    assert any(v > cell.limits[k] for k, v in ctl.items()), ctl


def test_answer_altered_is_not_correct(monkeypatch):
    from popsift_tpu_torch import api
    init = api.FeaturesHost.__init__

    def shifted(self, raw):
        init(self, raw)
        self.x = self.x + 1.0
    monkeypatch.setattr(api.FeaturesHost, "__init__", shifted)
    result, _ = run(small_cell("video1080_stream"))
    assert not result["correct"]
    assert result["checks"]["kp_miss_pct"]["value"] == 100.0


def test_half_of_a_batch_left_out_is_not_correct(monkeypatch):
    from popsift_tpu_torch import api
    batch = api.PopSift.enqueue_batch

    def half(self, images):
        jobs = batch(self, list(images)[:len(images) // 2])
        return jobs + jobs
    monkeypatch.setattr(api.PopSift, "enqueue_batch", half)
    result, _ = run(small_cell("video1080_batch4"))
    assert not result["correct"]


@pytest.mark.parametrize("where", ["match", "ransac"])
def test_pair_answer_altered_is_not_correct(monkeypatch, where):
    from popsift_tpu_torch.ops import matching
    from popsift_tpu_torch.sfm import twoview
    if where == "match":
        real = matching.match_descriptors

        def wrong(*a, **k):
            res = real(*a, **k)
            return res._replace(best_idx=torch.roll(res.best_idx, 1))
        monkeypatch.setattr(matching, "match_descriptors", wrong)
    else:
        real = twoview.ransac_homography

        def wrong(*a, **k):
            res = real(*a, **k)
            return res._replace(inliers=~res.inliers)
        monkeypatch.setattr(twoview, "ransac_homography", wrong)
    result, _ = run(small_cell("oxford_pair_homography"))
    assert not result["correct"]
    key = "match_miss_pct" if where == "match" else "inlier_miss_pct"
    assert result["checks"][key]["value"] > 50.0


def test_run_refuses_without_a_card(tmp_path):
    """run.py exits non-zero and prints no result where torch finds no
    CUDA card (this machine), and in a directory holding only
    BENCHMARK.json and the benchmark."""
    import shutil
    import subprocess
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "video1080_stream", "--seed", "5", "--seconds",
                            "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
        assert not np.any([line.startswith("{")
                           for line in p.stdout.splitlines()])


@pytest.mark.parametrize("name", ["video1080_stream",
                                  "oxford_pair_homography"])
def test_a_fault_after_the_first_pass_is_not_correct(monkeypatch, name):
    """Requests after the first pass over the pool lose a keypoint (an
    extraction) or a match (a pair): their counts no longer agree with
    the judged results of their frame or pair."""
    from popsift_tpu_torch import api
    from popsift_tpu_torch.ops import matching
    cell = small_cell(name)
    late = 2 + int(cell.traffic["pool"])          # warm-up and first pass
    calls = {"n": 0}
    if name == "video1080_stream":
        init = api.FeaturesHost.__init__

        def fewer(self, raw):
            init(self, raw)
            calls["n"] += 1
            if calls["n"] > late:
                keep = self.desc_to_kp < len(self.x) - 1
                self.descriptors = self.descriptors[keep]
                self.desc_to_kp = self.desc_to_kp[keep]
                for k in ("x", "y", "sigma", "octave", "num_ori",
                          "orientations", "ori_valid"):
                    setattr(self, k, getattr(self, k)[:-1])
        monkeypatch.setattr(api.FeaturesHost, "__init__", fewer)
    else:
        cell.traffic = dict(cell.traffic, pool=2)
        real = matching.match_descriptors
        late = 2 * 2                              # warm-up and first pass

        def fewer(*a, **k):
            res = real(*a, **k)
            calls["n"] += 1
            if calls["n"] <= late:
                return res
            acc = res.accept.clone()
            acc[torch.nonzero(acc)[0, 0]] = False
            return res._replace(accept=acc)
        monkeypatch.setattr(matching, "match_descriptors", fewer)
    result, _ = run(cell, seconds=3.0)
    assert result["attempted"] > late
    assert result["checks"]["count_mismatch"]["value"] > 0
    assert not result["correct"]
