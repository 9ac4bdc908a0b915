"""Bundle adjustment (``sfm/ba.py::bundle_adjust``): the bound of the
profiled stretch's problems (``harness/ba_bounds.py``: the work a sparse
Schur solver needs, counted from the reference's counts) over the device
time of the operations that ran inside the driver's ``bench/ba`` spans,
in %."""

from harness import ba_bounds


def read(run):
    if run.trace is None or not run.work or "ba" not in run.work:
        return None
    t = run.trace.device_s(inside="ba")
    if t <= 0:
        return None
    bound = sum(ba_bounds.ba_bound(*counts, run.work["iters"])
                for counts in run.work["ba"])
    return 100.0 * bound / t
