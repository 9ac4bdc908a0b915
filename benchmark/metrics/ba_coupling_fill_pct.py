"""Share (%) of the dense camera-point coupling blocks of the profiled
stretch's Schur steps that hold an observation: the program's
``ba.coupling_obs`` over ``ba.coupling_blocks`` (Np x Nc a dense step);
None on a program without those counters."""

from harness import program_spans


def read(run):
    obs = program_spans.counter("ba.coupling_obs")
    blocks = program_spans.counter("ba.coupling_blocks")
    if run.trace is None or obs is None or not blocks:
        return None
    return 100.0 * obs / blocks
