"""Share (%) of the descriptor job rows handed to K4 over the profiled
stretch that held a descriptor kept on the host (the program's
``rows_valid.desc`` and ``rows_padded.desc`` counters)."""

from harness import program_spans


def read(run):
    valid = program_spans.counter("rows_valid.desc")
    padded = program_spans.counter("rows_padded.desc")
    if run.trace is None or valid is None or not padded:
        return None
    return 100.0 * valid / padded
