"""Seconds from the process's start to the first timed request: imports,
the CUDA context, the kernel library (built on a checkout's first run),
the frames, the program and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
