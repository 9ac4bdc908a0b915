"""Host ms a pair of the point preparation (read-backs, padding,
upload), ``ransac_homography`` and the read-back of the inliers, ending
in a synchronize; median over the traced run's requests outside the
profiled stretch."""

import statistics


def read(run):
    v = run.layers.get("ransac")
    return statistics.median(v) * 1e3 if v else None
