"""Frames by ``make_frame``'s formula (bench.py), rendered on the card:
frame ``k`` of a pool draws from ``numpy.random.default_rng([seed, k])``."""

from __future__ import annotations

import numpy as np

from harness.frames import make_frame_on


def frame(spec: dict, h: int, w: int, seed: int, k: int, device) -> np.ndarray:
    return make_frame_on(device, h, w, [seed, k])
