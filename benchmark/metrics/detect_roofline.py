"""K1, the compaction and K2 (``csrc/extrema_mask.cu``, ``compact.cu``,
``refine.cu``): the sum of their bounds for the stretch's frames over
their summed device time, in %."""

from harness import bounds


def read(run):
    if run.trace is None or not run.work or "frames" not in run.work:
        return None
    w = run.work
    t = run.trace.device_s(["K1", "compaction", "K2"])
    if t <= 0:
        return None
    n = len(w["frames"])
    bound = (bounds.mask_bound(w["dims"], w["levels_searched"], n)
             + bounds.compact_bound(w["dims"], w["levels_searched"],
                                    w["caps"], n)
             + sum(bounds.refine_bound(int(f["candidates"].sum()),
                                       sum(w["caps"])) for f in w["frames"]))
    return 100.0 * bound / t
