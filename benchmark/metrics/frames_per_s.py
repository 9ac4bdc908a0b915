"""Frames whose features reached the host in the window, over the
window's seconds (host clock)."""


def read(run):
    if "frames" not in run.units or run.window_s <= 0:
        return None
    return run.units["frames"] / run.window_s
