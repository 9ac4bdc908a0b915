"""Share (%) of the stretch's frames whose ``get`` copied only the rows
``FeaturesHost`` keeps, packed on the device (the program's
``frames.packed`` and ``frames`` counters); None on a program without a
``frames.packed`` counter."""

from harness import program_spans


def read(run):
    packed = program_spans.counter("frames.packed")
    frames = program_spans.counter("frames")
    if run.trace is None or packed is None or not frames:
        return None
    return 100.0 * packed / frames
