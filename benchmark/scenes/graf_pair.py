"""Pairs of views of one synthetic planar scene, the second seen
through a homography like those of the Oxford affine set's ``graf``
sequence (a viewpoint change: in-plane rotation, scale and perspective
foreshortening about the frame's centre), each view with its own sensor
noise. Pair ``k`` of a pool draws from ``numpy.random.default_rng([seed,
k])``: the blobs (``make_frame``'s formula with the spec's count and
ranges), the homography, then each view's noise. ``frame`` gives the
views of the pool's pairs in turn (left, right, left, ...).
"""

from __future__ import annotations

import math

import numpy as np

from harness.frames import blob_scene, draw_blobs


def homography(rng: np.random.Generator, h: int, w: int, spec: dict):
    """Scene-to-view 3 x 3: rotation by +-U(rotation_deg), scale
    U(scale), perspective terms U(-perspective, perspective) per pixel,
    about the centre."""
    th = math.radians(rng.uniform(*spec["rotation_deg"])) \
        * rng.choice([-1.0, 1.0])
    s = rng.uniform(*spec["scale"])
    px, py = rng.uniform(-spec["perspective"], spec["perspective"], 2)
    c = np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1]], np.float64)
    ci = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]], np.float64)
    a = np.array([[s * math.cos(th), -s * math.sin(th), 0],
                  [s * math.sin(th), s * math.cos(th), 0],
                  [px, py, 1.0]])
    H = c @ a @ ci
    return H / H[2, 2]


def pair(spec: dict, h: int, w: int, seed: int, k: int, device):
    """(left, right, H): uint8 [h, w] views and the homography that maps
    left pixels to right pixels."""
    rng = np.random.default_rng([seed, k])
    blobs = draw_blobs(rng, h, w, spec["blobs"], tuple(spec["blob_sigma"]),
                       tuple(spec["blob_amplitude"]))
    H = homography(rng, h, w, spec["homography"])
    noise = [rng.normal(0, spec["noise"], size=(h, w)).astype(np.float32)
             for _ in range(2)]
    return (blob_scene(blobs, noise[0], device),
            blob_scene(blobs, noise[1], device, homography=H), H)


def frame(spec: dict, h: int, w: int, seed: int, k: int, device) -> np.ndarray:
    return pair(spec, h, w, seed, k // 2, device)[k % 2]
