"""Tracing and timing helpers on PyTorch.

Counterpart of :mod:`popsift_tpu.utils.profiling` (the reference's NVTX
ranges, popsift.h:22-27, and its ``BriefDuration`` CUDA-event timer,
common/debug_macros.h:81-114):

* :func:`trace_scope` names a host region for ``torch.profiler``
  (``record_function``) and, when a CUDA device is present, for NVTX as
  well;
* :func:`device_trace` records a ``torch.profiler`` trace of a block
  (the host and, on a CUDA machine, the device) into a directory;
* :class:`BriefDuration` times a block with CUDA events on a CUDA
  device, with the host clock on the CPU;
* :class:`StageTimer` sums the wall time of named stages and prints the
  same table as the JAX package's.

Nothing here costs anything unless it is entered.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace_scope(name: str):
    """Name the enclosed host region in a ``torch.profiler`` trace and,
    on a machine with a CUDA device, as an NVTX range."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed block (the CPU,
    and CUDA when a device is present) and write it to
    ``log_dir/trace.json`` (Chrome trace format)::

        with device_trace("/tmp/profile"):
            ps.enqueue(img).get()
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class BriefDuration:
    """Block timer (BriefDuration, debug_macros.h:81-114): CUDA events on
    a CUDA ``device``, the host clock otherwise. ``stop`` waits for the
    work queued since the start and returns milliseconds::

        t = BriefDuration("extract", device)
        out = extract(img, plan, device)
        ms = t.stop()
    """

    def __init__(self, name: str = "", device=None):
        self.name = name
        self._cuda = (device is not None
                      and torch.device(device).type == "cuda")
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Milliseconds since the start; ``result`` is accepted for the
        JAX package's signature (the events already order the work)."""
        if self._cuda:
            self._end.record()
            self._end.synchronize()
            ms = self._start.elapsed_time(self._end)
        else:
            ms = (time.perf_counter() - self._t0) * 1000.0
        if self.name:
            print(f"[{self.name}] {ms:.2f} ms")
        return ms


@dataclass
class StageTimer:
    """Sums per-stage wall times across frames and prints a summary (the
    --print-time-info reporting the reference declares, main.cpp:117)."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_ref: list | None = None):
        t0 = time.perf_counter()
        with trace_scope(name):
            yield
        dt = (time.perf_counter() - t0) * 1000.0
        total, count = self.stages.get(name, (0.0, 0))
        self.stages[name] = (total + dt, count + 1)

    def summary(self) -> str:
        lines = ["stage                     total(ms)   mean(ms)  calls"]
        for name, (total, count) in sorted(self.stages.items()):
            lines.append(f"{name:24s} {total:10.2f} {total / count:10.2f}"
                         f" {count:6d}")
        return "\n".join(lines)

    def print(self):
        print(self.summary())
