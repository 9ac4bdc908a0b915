"""The port's one tracing system: spans and counters, and a profiler trace
of a block.

Counterpart of :mod:`popsift_tpu.utils.profiling` (the reference's NVTX
ranges, popsift.h:22-27, and its ``--print-time-info`` table,
main.cpp:117):

* :func:`span` names a stage of the program. Off (the default) it returns
  a shared no-op context after reading two flags. It is on while a
  ``torch.profiler`` session records, and after ``enable_tracing(True)``.
  On, each span records its request, its own id, its parent's id, its
  name and its start and end on ``time.perf_counter_ns`` into a buffer of
  the last :data:`BUFFER` spans; under a profiler it leaves a zero-length
  mark ``popsift/<name>`` where it starts and ``popsift/<name>/end``
  where it ends; on a machine with a CUDA device it also pushes and pops
  an NVTX range of its name.
* :func:`count` adds to the current request's counters and to the
  process's totals, only while tracing is on. :func:`to_host` is a
  blocking device-to-host read, counted as one of ``host_syncs`` and
  its bytes as ``d2h_bytes``; :func:`queue_to_host` queues a copy into
  pinned host memory, counted in ``d2h_bytes``, and :func:`wait` is the
  blocking wait for such copies, one of ``host_syncs``.
* :func:`spans`, :func:`counters` and :func:`reset` read and clear what
  was recorded; :func:`summary` is the table of self host ms per span
  name and the counters a request.
* :func:`device_trace` records a ``torch.profiler`` trace of a block
  into a directory.

A span opened where no span is open starts a request (``PopSift.enqueue``
and ``enqueue_batch``); a span with an explicit ``request`` joins it (a
job's ``get``); any other span joins its parent's request.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from torch._C._profiler import _RecordFunctionFast as _Mark

MARK_PREFIX = "popsift/"
BUFFER = 65536                # spans, and requests with counters, kept

_on = False                   # enable_tracing's switch
_cuda = None                  # torch.cuda.is_available(), read once on
_spans = deque(maxlen=BUFFER)     # (request, id, parent, name, t0, t1) ns
_totals: dict = {}
_requests: OrderedDict = OrderedDict()    # request -> {counter: n}
_request_ids = itertools.count(1)
_span_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


def enable_tracing(on: bool = True) -> None:
    """The operator's switch: record spans and counters whether or not
    a profiler records."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    """Whether spans and counters record now."""
    return _on or _autograd_profiler._is_profiler_enabled


class _Off:
    """The span while tracing is off: one shared object, no state."""

    __slots__ = ()
    request = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def _mark(name: str) -> None:
    # A zero-length mark, never a range: a range that launches kernels
    # leaves a device-side annotation over them, which readers of the
    # profile would count as device work.
    with _Mark(name):
        pass


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "request", "id", "parent", "t0", "marks", "nvtx")

    def __init__(self, name: str, request):
        self.name = name
        self.request = request

    def __enter__(self):
        global _cuda
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.request is None:
            self.request = (parent.request if parent is not None
                            else next(_request_ids))
        self.id = next(_span_ids)
        stack.append(self)
        self.marks = _autograd_profiler._is_profiler_enabled
        if self.marks:
            _mark(MARK_PREFIX + self.name)
        if _cuda is None:
            _cuda = torch.cuda.is_available()
        self.nvtx = _cuda
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.marks:
            _mark(MARK_PREFIX + self.name + "/end")
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _spans.append((self.request, self.id, self.parent, self.name,
                       self.t0, t1))
        return False


def span(name: str, request=None):
    """A context that records the enclosed stage as a span named
    ``name`` while tracing is on, and does nothing otherwise. Entered,
    it gives an object whose ``request`` is the span's request id (None
    while tracing is off)."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current request and of the
    process, while tracing is on."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    request = stack[-1].request if stack else None
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
        if request is not None:
            c = _requests.get(request)
            if c is None:
                c = _requests[request] = {}
                if len(_requests) > BUFFER:
                    _requests.popitem(last=False)
            c[name] = c.get(name, 0) + n


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host: a blocking device-to-host read
    on a device, counted as one of ``host_syncs`` and its bytes as
    ``d2h_bytes``."""
    if _on or _autograd_profiler._is_profiler_enabled:
        count("host_syncs")
        count("d2h_bytes", t.nbytes)
    return t.cpu().numpy()


def queue_to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` of its own, its bytes counted as
    ``d2h_bytes``. From a CUDA device the copy lands in pinned memory and
    is queued on the current stream: complete once a later :func:`wait`
    returns."""
    if _on or _autograd_profiler._is_profiler_enabled:
        count("d2h_bytes", t.nbytes)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return out.copy_(t, non_blocking=True)


def stream_mark(device: torch.device):
    """An event recorded on ``device``'s current stream, or None on a
    device whose work is done when queued (the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def wait(mark) -> None:
    """Block until the stream has passed ``mark`` (:func:`stream_mark`;
    None returns at once), counted as one of ``host_syncs``."""
    if _on or _autograd_profiler._is_profiler_enabled:
        count("host_syncs")
    if mark is not None:
        mark.synchronize()


def spans() -> list:
    """The recorded spans, oldest first, as dicts (times in ns on
    ``time.perf_counter_ns``)."""
    keys = ("request", "id", "parent", "name", "start_ns", "end_ns")
    return [dict(zip(keys, s)) for s in list(_spans)]


def counters(request: int | None = None) -> dict:
    """The process's counter totals, or those of one request."""
    with _lock:
        return dict(_totals if request is None
                    else _requests.get(request, {}))


def reset() -> None:
    """Drop every recorded span and counter."""
    with _lock:
        _spans.clear()
        _totals.clear()
        _requests.clear()


def summary() -> str:
    """Self host ms per span name (a span's time less its children's)
    and each counter's mean over the requests that counted it."""
    recs = list(_spans)
    child_ns: dict = {}
    for _, _, parent, _, t0, t1 in recs:
        if parent is not None:
            child_ns[parent] = child_ns.get(parent, 0) + (t1 - t0)
    by: dict = {}
    for _, sid, _, name, t0, t1 in recs:
        total, calls = by.get(name, (0, 0))
        by[name] = (total + (t1 - t0) - child_ns.get(sid, 0), calls + 1)
    lines = ["span                   calls  self ms total  self ms a call"]
    for name, (total, calls) in sorted(by.items()):
        lines.append(f"{name:20s} {calls:7d} {total / 1e6:14.3f}"
                     f" {total / 1e6 / calls:16.3f}")
    with _lock:
        reqs = [dict(c) for c in _requests.values()]
    if reqs:
        lines.append("counter                 requests     a request")
        for name in sorted({k for c in reqs for k in c}):
            vals = [c[name] for c in reqs if name in c]
            lines.append(f"{name:20s} {len(vals):11d}"
                         f" {sum(vals) / len(vals):13.1f}")
    return "\n".join(lines)


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
