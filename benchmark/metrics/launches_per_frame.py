"""CUDA launch calls (the profiler's runtime events) a frame over the
profiled stretch."""


def read(run):
    if run.trace is None or not run.stretch_units:
        return None
    return run.trace.launches / run.stretch_units
