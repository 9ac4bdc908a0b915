"""Find a cell and everything it names, by name, from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is a file of its own: ``benchmark/configs/<config>.json``
(the configuration's ``file``), ``benchmark/traffic/<traffic>.json``,
whose ``driver`` names ``benchmark/drivers/<driver>.py``, and
``benchmark/limits/<cell>.json``, the limits of the numbers that decide
``correct``. Every metric is a reader ``benchmark/metrics/<metric>.py``.
A cell, a mix, a driver or a metric is added as files and an entry;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """The module in ``path`` (a file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    driver, limits and the metrics it reports."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        bench_dir = os.path.join(root, "benchmark")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.driver = load_module(
            os.path.join(bench_dir, "drivers", self.traffic["driver"] + ".py"),
            "bench_driver_" + self.traffic["driver"])
        self.limits = load_json(os.path.join(bench_dir, "limits",
                                             name + ".json"))
        self.end_to_end = [m for m in self.spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e_names)]

    def reader(self, metric: str):
        """The ``read(run)`` function of a metric."""
        path = os.path.join(self.root, "benchmark", "metrics",
                            metric + ".py")
        return load_module(path, "bench_metric_" + metric.replace(".", "_")
                           ).read
