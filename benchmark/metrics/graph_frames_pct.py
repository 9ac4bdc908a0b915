"""Share (%) of the stretch's frames that the program extracted by
replaying a captured CUDA graph (its ``frames.graph`` and ``frames``
counters); None on a program without a ``frames.graph`` counter."""

from harness import program_spans


def read(run):
    graph = program_spans.counter("frames.graph")
    frames = program_spans.counter("frames")
    if run.trace is None or graph is None or not frames:
        return None
    return 100.0 * graph / frames
