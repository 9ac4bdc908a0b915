"""K3 (``csrc/orient.cu``): ``ori_bound`` of each frame's refined
keypoints over K3's device time, in %."""

from harness import bounds


def read(run):
    if run.trace is None or not run.work or "frames" not in run.work:
        return None
    w = run.work
    t = run.trace.device_s(["K3"])
    if t <= 0:
        return None
    bound = sum(bounds.ori_bound(f["refined_sigma"], sum(w["caps"]))
                for f in w["frames"])
    return 100.0 * bound / t
