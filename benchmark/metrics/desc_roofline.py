"""K4 (``csrc/desc.cu``): ``desc_bound`` of each frame's descriptor jobs
over K4's device time, in %."""

from harness import bounds


def read(run):
    if run.trace is None or not run.work or "frames" not in run.work:
        return None
    w = run.work
    t = run.trace.device_s(["K4"])
    if t <= 0:
        return None
    rows = sum(c + c // 4 for c in w["caps"])
    bound = sum(bounds.desc_bound(f["job_sigma"], w["radius"], rows)
                for f in w["frames"])
    return 100.0 * bound / t
