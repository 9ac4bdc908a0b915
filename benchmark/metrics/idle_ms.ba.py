"""Device idle ms a problem inside the program's ``ba`` span, whole
(``bundle_adjust``: linearisation, reduction, solve and trial of every
iteration), over the profiled stretch: the host's dispatch showing
through."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_unit(run, ("ba",), whole=True)
