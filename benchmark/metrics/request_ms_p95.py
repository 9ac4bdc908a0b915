"""95th percentile (ms) of the latency of every request of the window,
from the call to the result on the host (host clock); the exclusive
quantile of ``statistics.quantiles``."""

import statistics


def read(run):
    if len(run.request_s) < 2:
        return None
    return statistics.quantiles(run.request_s, n=100)[94] * 1e3
