"""Device idle ms a frame inside the self interval of the program's
``orient`` span, orientation (K3 and the orientation tail), over the
profiled stretch."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("orient",))
