"""Device idle ms a frame inside the self interval of the program's
``desc`` span, descriptors (the job build, K4, the reorder, the
normalisation), over the profiled stretch."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("desc",))
