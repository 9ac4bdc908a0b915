"""The program's own spans and counters in a traced run.

While a profiler records, popsift_tpu_torch leaves a zero-length mark
``popsift/<name>`` where each of its spans starts and
``popsift/<name>/end`` where it ends (``utils/profiling.py``). This
module pairs those marks among a :class:`harness.trace.Trace`'s host
events into spans, gives a span's self interval (the span less its
children) and the device's idle time inside a set of intervals, from the
trace's busy union. The program's counters accrue while the stretch's
profiler records; :func:`counter` reads their process totals. Every
reader finds nothing, and returns None, on a program without marks or
counters.
"""

from __future__ import annotations

PREFIX = "popsift/"
END = "/end"


def spans(trace) -> list:
    """The program's spans in the stretch as a tree: the outermost spans
    in order, each a dict of ``name``, ``start`` and ``end`` (us) and
    ``children`` (spans in the same form). An end mark that closes no
    open span, and a begin mark never closed, are dropped."""
    out, stack = [], []
    for t0, _, name, _ in trace._cpu:
        if not name.startswith(PREFIX) or not trace.t0 <= t0 <= trace.t1:
            continue
        name = name[len(PREFIX):]
        if not name.endswith(END):
            stack.append(dict(name=name, start=t0, end=None, children=[]))
        elif stack and stack[-1]["name"] == name[:-len(END)]:
            s = stack.pop()
            s["end"] = t0
            (stack[-1]["children"] if stack else out).append(s)
    return out


def walk(tree: list):
    """Every span of a tree, each before its children."""
    for s in tree:
        yield s
        yield from walk(s["children"])


def intervals(tree: list, names, whole: bool = False) -> list:
    """The intervals (us) of the spans named in ``names``: each span's
    self interval (its children's taken out), or with ``whole`` the
    span itself."""
    out = []
    for s in walk(tree):
        if s["name"] not in names:
            continue
        t = s["start"]
        for c in ([] if whole else s["children"]):
            if c["start"] > t:
                out.append((t, c["start"]))
            t = max(t, c["end"])
        if s["end"] > t:
            out.append((t, s["end"]))
    return out


def idle_s(trace, ivals: list) -> float:
    """Seconds of ``ivals`` (us, disjoint) in which the device ran
    nothing, from the trace's busy union."""
    busy = trace._union()
    total = 0.0
    for a, b in ivals:
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy
                      if x < b and y > a)
        total += (b - a) - covered
    return total * 1e-6


def complement(trace, ivals: list) -> list:
    """The parts of the stretch outside ``ivals`` (disjoint)."""
    out, t = [], trace.t0
    for a, b in sorted(ivals):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        out.append((t, trace.t1))
    return out


def idle_ms_per_unit(run, names, whole: bool = False):
    """Device idle ms a unit of the stretch inside the spans named in
    ``names`` (self intervals, or whole spans with ``whole``), or None
    where the stretch holds no such span."""
    if run.trace is None or not run.stretch_units:
        return None
    tree = spans(run.trace)
    if not any(s["name"] in names for s in walk(tree)):
        return None
    return idle_s(run.trace, intervals(tree, names, whole)) \
        / run.stretch_units * 1e3


def counter(name: str):
    """The program's process total of counter ``name``, or None where
    the program keeps no such counter."""
    try:
        from popsift_tpu_torch.utils import profiling
        totals = profiling.counters()
    except (ImportError, AttributeError):
        return None
    return totals.get(name)
