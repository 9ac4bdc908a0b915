"""CUDA launch calls (the profiler's runtime events) of the profiled
stretch per LM iteration (the program's ``ba.iters`` counter); None on a
program without that counter."""

from harness import program_spans


def read(run):
    iters = program_spans.counter("ba.iters")
    if run.trace is None or not iters:
        return None
    return run.trace.launches / iters
