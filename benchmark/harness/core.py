"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

The cell's driver (``benchmark/drivers/<driver>.py``) knows its requests;
this module knows the window. A driver module provides:

* ``UNIT``: what a request completes ("frames" or "pairs");
* ``prepare(ctx, stamps)``: make the inputs, build the program and warm
  up the cell's own shapes, noting the seconds of each step in
  ``stamps``; returns the driver's state;
* ``request(state, i, traced)``: request ``i`` (a closed loop: the next
  starts when it returns); returns ``(units, record)``, where ``record``
  holds what the request brought to the host and, when ``traced``, the
  host seconds of each layer (``record["layers"]``, per unit) measured
  with a synchronize between layers;
* ``min_requests(state)``: requests the window runs even past its
  seconds, so that every request the check samples is made;
* ``release(state, records)``: bring what the check needs to the host
  and drop the program's device state, after the window;
* ``judge(state, records, dtype)``: the numbers that decide ``correct``
  (each compared with the cell's limit), from the reference computed in
  ``dtype``, and a dict of readings for the record;
* ``work(state, records)``: what the roofline readers need of the
  requests in ``records`` (sizes and counts, from the reference);
* ``control(state, records, dtype)``: the same numbers with the
  reference computed in ``dtype`` put in the program's place (for
  ``benchmark/control.py``, not for the benchmark's runs).

The traced run (``--trace 1``) profiles one stretch of whole requests
early in the window (``traffic["trace_requests"]``). Of the requests
after it, every other one has its layers timed on the host clock; the
rest take the untraced run's path, and their latencies
(``Run.plain_s``) stand for the window's requests there.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from . import trace as trace_mod

BANNED = ("jax", "jaxlib", "flax", "popsift_tpu")


class Run:
    """What the metric readers read: the window's counts and times, the
    setup, the traced stretch and its work, the layer times."""

    def __init__(self):
        self.units = {}          # unit -> completed in the window
        self.window_s = 0.0
        self.request_s = []      # every request's latency
        self.plain_s = []        # traced run: latencies on the untraced path
        self.setup_s = 0.0
        self.layers = {}         # layer -> [seconds per unit]
        self.trace = None        # trace.Trace of the stretch, or None
        self.stretch_units = 0
        self.work = None         # driver.work() of the stretch's requests
        self.state = None        # the driver's state, for control()
        self.records = []


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def ctx_for(cell, seed: int, device) -> dict:
    return dict(config=cell.config, traffic=cell.traffic, seed=seed,
                device=device, cell=cell.name,
                bench=os.path.join(cell.root, "benchmark"))


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, say=print):
    """One run. Returns (result dict without ``device``, Run)."""
    drv = cell.driver
    stamps = {"imports_s": time.perf_counter() - t_start}
    state = drv.prepare(ctx_for(cell, seed, device), stamps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run = Run()
    run.setup_s = time.perf_counter() - t_start
    stamps["total"] = run.setup_s
    lo = int(cell.traffic.get("trace_skip", 2))
    hi = lo + int(cell.traffic.get("trace_requests", 8))
    least = max(drv.min_requests(state), hi if traced else 0)
    records, attempted, failed = [], 0, 0
    prof = stretch = None
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        in_stretch = traced and lo <= i < hi
        layered = traced and (i < hi or i % 2 == 0)
        if now - t0 >= seconds and i >= least:
            break
        if traced and i == lo:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            stretch = torch.profiler.record_function("bench/stretch")
            stretch.__enter__()
        attempted += 1
        a = time.perf_counter()
        try:
            units, rec = drv.request(state, i, layered)
        except Exception as exc:          # a request that fails is counted
            failed += 1
            say(f"request {i} failed: {exc!r}")
            units, rec = 0, None
        b = time.perf_counter()
        run.request_s.append(b - a)
        if traced and not layered:
            run.plain_s.append(b - a)
        if rec is not None:
            rec["index"] = i
            rec["in_stretch"] = in_stretch
            records.append(rec)
            run.units[drv.UNIT] = run.units.get(drv.UNIT, 0) + units
            if in_stretch:
                run.stretch_units += units
            elif traced:
                for k, v in rec.get("layers", {}).items():
                    run.layers.setdefault(k, []).extend(v)
        if traced and i == hi - 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stretch.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        i += 1
    run.window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = banned_modules()
    if found:
        raise SystemExit(f"the run loaded {found}; no JAX may run here")
    drv.release(state, records)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    numbers, readings = drv.judge(state, records, torch.float64)
    readings["judge_s"] = time.perf_counter() - t_judge
    tenth = max(1, len(run.request_s) // 10)
    readings["request_ms_median_by_tenth"] = [
        statistics.median(run.request_s[a:a + tenth]) * 1e3
        for a in range(0, len(run.request_s) - tenth + 1, tenth)][:10]
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = (failed == 0 and bool(records)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    run.state, run.records = state, records
    if traced and prof is not None:
        t_trace = time.perf_counter()
        run.trace = trace_mod.Trace(prof)
        run.work = drv.work(state, [r for r in records if r["in_stretch"]])
        readings["trace_s"] = time.perf_counter() - t_trace
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "memory_peak_bytes": peak}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["setup"] = stamps
    result["readings"] = readings
    result["checks"] = checks
    return result, run


def write_summary(root: str, name: str, seed: int, result: dict,
                  run: Run) -> str:
    """The traced run's profile summary, in the checkout for later
    reading: ``bench_out/<cell>-<seed>.json``."""
    out = os.path.join(root, "bench_out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{name}-{seed}.json")
    t = run.trace
    summary = {"cell": name, "seed": seed,
               "stretch_units": run.stretch_units,
               "window_s": t.window_s, "busy_s": t.busy_s,
               "launches": t.launches,
               "device_ops": t.top_device_ops(60),
               "idle_gaps": t.idle_gaps(60),
               "layers_median_s": {k: statistics.median(v)
                                   for k, v in run.layers.items() if v},
               "metrics": result["metrics"], "checks": result["checks"],
               "readings": result["readings"], "setup": result["setup"]}
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    return path
