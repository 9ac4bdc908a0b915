"""Device selection.

Every public entry point of the port takes its device explicitly. A
request for a CUDA device on a machine without one raises: nothing falls
back to the CPU on its own, so a run that asked for the card either ran
on the card or failed.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Return the ``torch.device`` for ``device`` ("cpu", "cuda",
    "cuda:N" or a ``torch.device``); raises RuntimeError when a CUDA
    device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
