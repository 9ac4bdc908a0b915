"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of cells, configurations, traffic, drivers, limits and metrics
by name."""

from __future__ import annotations

import ast
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from harness.spec import NAME, UNIT, Cell  # noqa: E402

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert len(entry["unit"]) <= 16
            keys = ("why", "layer") + (("source",) if group == "configs"
                                       else ())
            for key in keys:
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], key)
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for group in ("configs", "workloads"):
        ns = [n for g, n in names if g == group]
        assert len(ns) == len(set(ns))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in CELLS:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", CELLS)]
        assert len(reported) >= 2 and "setup_s" in {m["name"]
                                                    for m in reported}
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_configs_and_cells_found_by_name():
    used = set()
    for name in CELLS:
        cell = Cell(name, ROOT)
        used.add(cell.workload["config"])
        assert cell.config["name"] == cell.workload["config"]
        assert cell.config["reduced"] == cell.config_entry["reduced"]
        assert hasattr(cell.driver, "request") and cell.driver.UNIT
        assert cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new traffic mix, limits, metric and cell added as files and
    entries in a copy, with no edit to an existing file."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "video1080_pool2",
                              "config": "popsift_default_1080p",
                              "traffic": "pool2", "chips": 1,
                              "why": "two frames cycled"})
    spec["per_layer"].append({"name": "frames_in_stretch", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "Device", "moves": "frames_per_s",
                              "workloads": ["video1080_pool2"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("frames_per_s", "request_ms_p95"):
            m["workloads"].append("video1080_pool2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark" / "traffic" / "pool2.json").write_text(
        json.dumps({"driver": "extract", "pool": 2, "batch": 1,
                    "keep_share": 0.5}))
    (tmp_path / "benchmark" / "limits" / "video1080_pool2.json").write_text(
        json.dumps({"kp_miss_pct": 1.0, "desc_miss_pct": 1.0}))
    (tmp_path / "benchmark" / "metrics" / "frames_in_stretch.py").write_text(
        "def read(run):\n    return run.stretch_units\n")
    cell = Cell("video1080_pool2", str(tmp_path))
    assert cell.traffic["pool"] == 2
    assert cell.limits == {"kp_miss_pct": 1.0, "desc_miss_pct": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["frames_in_stretch"]
    assert {m["name"] for m in cell.end_to_end} == {
        "frames_per_s", "request_ms_p95", "setup_s"}

    class R:
        stretch_units = 8
    assert cell.reader("frames_in_stretch")(R()) == 8
    with pytest.raises(KeyError):
        Cell("no_such_cell", str(tmp_path))


BANNED = {"jax", "jaxlib", "flax", "popsift_tpu"}


def _top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(BENCH)
             for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        found = _top_level_imports(path) & BANNED
        assert not found, f"{path} imports {found}"


def test_the_check_compares_whole_top_level_names():
    from harness.core import BANNED as RUNTIME
    assert set(RUNTIME) == BANNED
    assert "popsift_tpu_torch".split(".")[0] not in BANNED
    assert "popsift_tpu.ops".split(".")[0] in BANNED
    assert _top_level_imports(__file__) & BANNED == set()
