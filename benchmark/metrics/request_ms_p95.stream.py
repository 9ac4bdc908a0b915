"""95th percentile (ms) of request latency in the traced run, over the
requests after the profiled stretch that take the untraced run's path
(every other one), from the call to the result on the host (host
clock). The per-layer stand-in for ``request_ms_p95`` in a cell whose
tail swings with the host's phases by more than a bound can hold."""

import statistics


def read(run):
    if len(run.plain_s) < 2:
        return None
    return statistics.quantiles(run.plain_s, n=100)[94] * 1e3
