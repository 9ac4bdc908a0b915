"""Host ms a frame of ``SiftJob.get()`` (the copies of the padded result
to the host and the compaction in ``FeaturesHost``), started after a
synchronize; median over the traced run's requests outside the profiled
stretch."""

import statistics


def read(run):
    v = run.layers.get("readback")
    return statistics.median(v) * 1e3 if v else None
