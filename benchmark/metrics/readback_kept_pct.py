"""Share (%) of the bytes the program copied to the host over the
profiled stretch that ``FeaturesHost`` kept (its ``d2h_bytes_kept`` and
``d2h_bytes`` counters)."""

from harness import program_spans


def read(run):
    kept = program_spans.counter("d2h_bytes_kept")
    copied = program_spans.counter("d2h_bytes")
    if run.trace is None or kept is None or not copied:
        return None
    return 100.0 * kept / copied
