"""Device idle ms a frame inside the self interval of the program's
``front`` span, the pyramid (``build_pyramid_frames``), over the
profiled stretch."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("front",))
