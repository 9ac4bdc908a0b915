"""K5 (``csrc/blur_dog.cu``, level and thin entries): the bound of the
stretch's frames over K5's device time, in %."""

from harness import bounds


def read(run):
    if run.trace is None or not run.work or "frames" not in run.work:
        return None
    w = run.work
    t = run.trace.device_s(["K5", "K5 thin"])
    if t <= 0:
        return None
    bound = bounds.front_bound(w["dims"], w["half_spans"],
                               len(w["frames"]))
    return 100.0 * bound / t
