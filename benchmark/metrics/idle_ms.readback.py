"""Device idle ms a frame inside the program's ``get`` spans, their
children (``check``, ``copy``, ``compact``) included, over the profiled
stretch."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("get",), whole=True)
