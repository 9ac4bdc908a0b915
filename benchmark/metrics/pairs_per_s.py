"""Pairs whose inlier set reached the host in the window, over the
window's seconds (host clock)."""


def read(run):
    if "pairs" not in run.units or run.window_s <= 0:
        return None
    return run.units["pairs"] / run.window_s
