"""Host ms a pair of ``match_descriptors`` and the read-back of
``accept``, ending in a synchronize; median over the traced run's
requests outside the profiled stretch."""

import statistics


def read(run):
    v = run.layers.get("match")
    return statistics.median(v) * 1e3 if v else None
