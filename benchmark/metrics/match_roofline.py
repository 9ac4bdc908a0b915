"""The exact matcher (``ops/matching.py``): the bound of the padded rows
each match was given (2 x 128 f32 operations a row pair, or the distance
field's bytes) over the device time of the operations that ran inside
the match spans of the profiled stretch, in %."""

from harness import bounds


def read(run):
    if run.trace is None or not run.work or "match_rows" not in run.work:
        return None
    t = run.trace.device_s(inside="match")
    if t <= 0:
        return None
    bound = sum(bounds.match_bound(l, r) for l, r in run.work["match_rows"])
    return 100.0 * bound / t
