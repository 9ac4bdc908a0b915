"""Frame generators of the benchmark.

``make_frame`` is a copy of ``bench.py::make_frame`` (the 1080p frame
behind the repository's 2110-keypoint invariant), pure NumPy; the
harness does not import ``bench.py``. ``blob_scene``
renders ``make_frame``'s formula on the card, where NumPy spends seconds
on a 1080p frame: the same draws from the same generator, the image in
float32 on the device, optionally seen through a homography (the
formula is evaluated at the mapped coordinates, so a warped view has
content everywhere). The card's float32 exp differs from NumPy's in the
last bits, so a pixel here and there lies one grey level off
``make_frame``'s.
"""

from __future__ import annotations

import numpy as np
import torch


def make_frame(h=1080, w=1920, seed=0):
    """``bench.py::make_frame``, verbatim."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (96.0 + 40.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
           + 30.0 * np.sin(xx / 37.0 + yy / 23.0))
    for _ in range(64):
        cx, cy = rng.uniform(0.05, 0.95) * w, rng.uniform(0.05, 0.95) * h
        s = rng.uniform(1.5, 24.0)
        a = rng.uniform(40, 120) * rng.choice([-1.0, 1.0])
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img += rng.normal(0, 2.0, size=(h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_blobs(rng: np.random.Generator, h: int, w: int, n: int = 64,
               sigma=(1.5, 24.0), amplitude=(40.0, 120.0)) -> np.ndarray:
    """[n, 4] (cx, cy, s, a) drawn as ``make_frame`` draws them."""
    out = np.empty((n, 4))
    for i in range(n):
        cx, cy = rng.uniform(0.05, 0.95) * w, rng.uniform(0.05, 0.95) * h
        s = rng.uniform(*sigma)
        a = rng.uniform(*amplitude) * rng.choice([-1.0, 1.0])
        out[i] = (cx, cy, s, a)
    return out


def blob_scene(blobs: np.ndarray, noise: np.ndarray, device,
               homography: np.ndarray | None = None,
               chunk: int = 16) -> np.ndarray:
    """``make_frame``'s image of ``blobs`` ([n, 4]) plus ``noise``
    ([h, w]), rendered in float32 on ``device`` and returned as uint8
    host pixels. With ``homography`` (3 x 3, scene to view), pixel (x, y)
    of the view shows the scene at H^-1 (x, y)."""
    h, w = noise.shape
    dev = torch.device(device)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    if homography is not None:
        hinv = torch.as_tensor(np.linalg.inv(homography), dtype=torch.float64,
                               device=dev)
        pts = torch.stack([xx.double(), yy.double(), torch.ones_like(
            xx, dtype=torch.float64)])
        q = torch.einsum("ij,jhw->ihw", hinv, pts)
        xx, yy = (q[0] / q[2]).float(), (q[1] / q[2]).float()
    img = (96.0 + 40.0 * torch.sin(xx / 9.0) * torch.cos(yy / 11.0)
           + 30.0 * torch.sin(xx / 37.0 + yy / 23.0))
    b = torch.as_tensor(blobs, dtype=torch.float32, device=dev)
    for a0 in range(0, b.shape[0], chunk):
        c = b[a0:a0 + chunk, :, None, None]
        img = img + (c[:, 3] * torch.exp(
            -((xx - c[:, 0]) ** 2 + (yy - c[:, 1]) ** 2)
            / (2 * c[:, 2] * c[:, 2]))).sum(0)
    img = img + torch.as_tensor(noise, dtype=torch.float32, device=dev)
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def make_frame_on(device, h: int, w: int, seed) -> np.ndarray:
    """``make_frame(h, w, seed)`` rendered on ``device``."""
    rng = np.random.default_rng(seed)
    blobs = draw_blobs(rng, h, w)
    noise = rng.normal(0, 2.0, size=(h, w)).astype(np.float32)
    return blob_scene(blobs, noise, device)
