"""Share (%) of the stretch's exact matches (``match_descriptors`` calls)
that launched the hand-written matcher kernel (the program's
``match.kernel`` and ``match.calls`` counters); None on a program
without a ``match.calls`` counter."""

from harness import program_spans


def read(run):
    calls = program_spans.counter("match.calls")
    if run.trace is None or not calls:
        return None
    return 100.0 * (program_spans.counter("match.kernel") or 0) / calls
