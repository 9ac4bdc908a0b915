"""The program's blocking device-to-host reads a frame (its
``host_syncs`` counter) over the profiled stretch."""

from harness import program_spans


def read(run):
    n = program_spans.counter("host_syncs")
    if run.trace is None or not run.stretch_units or n is None:
        return None
    return n / run.stretch_units
