"""Device ms a frame of every operation that is not one of the
program's kernels (PyTorch's kernels, copies and memsets) over the
profiled stretch."""

from harness.trace import PORT_LABELS


def read(run):
    if run.trace is None or not run.stretch_units:
        return None
    t = run.trace
    return (t.device_s() - t.device_s(PORT_LABELS)) / run.stretch_units * 1e3
