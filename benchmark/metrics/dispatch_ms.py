"""Host ms a frame of ``enqueue`` / ``enqueue_batch``: the upload and
every launch queued, the call returning without waiting for the card;
median over the traced run's requests outside the profiled stretch."""

import statistics


def read(run):
    v = run.layers.get("dispatch")
    return statistics.median(v) * 1e3 if v else None
