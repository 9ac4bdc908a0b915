"""The configuration's scene generator, by name: ``scene["kind"]`` names
``<benchmark dir>/scenes/<kind>.py``, which gives ``frame(spec, h, w,
seed, k, device)`` (frame ``k`` of a pool, uint8 [h, w] on the host)
and, for a pair scene, ``pair(spec, h, w, seed, k, device)`` (left,
right and the true homography)."""

from __future__ import annotations

import os

from .spec import load_module


def load(bench_dir: str, spec: dict):
    return load_module(os.path.join(bench_dir, "scenes",
                                    spec["kind"] + ".py"),
                       "bench_scene_" + spec["kind"])
