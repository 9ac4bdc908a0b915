"""Image I/O: PGM/PPM read/write and grayscale conversion.

Counterpart of the reference's application-side loader
(pgmread.cpp:17-254: P2/P5/P6 with
integer RGB->gray using the OpenCV coefficients and maxval rescaling)
and the debug plane writers (common/write_plane_2d.cu:19-178).

The port's own copy of :mod:`popsift_tpu.io.image`. A C++ fast path
(:mod:`popsift_tpu_torch.runtime.native`) is used when the
compiled extension is available; this module is the always-available
fallback and the semantics reference.
"""

from __future__ import annotations

import io
import re

import numpy as np

# integer RGB -> gray coefficients (pgmread.cpp:17-33, OpenCV values):
# gray = (R*4899 + G*9617 + B*1868 + 8192) >> 14
_RW, _GW, _BW = 4899, 9617, 1868


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """Integer OpenCV-coefficient RGB->gray (pgmread.cpp:24-33)."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    return ((r * _RW + g * _GW + b * _BW + (1 << 13)) >> 14).astype(np.uint8)


def _read_header_tokens(data: bytes, count: int):
    """Read `count` whitespace-separated header tokens, skipping
    '#' comments (PNM spec; pgmread.cpp header scan)."""
    tokens = []
    pos = 0
    while len(tokens) < count:
        m = re.compile(rb"\s*(#[^\n]*\n\s*)*([^\s#]+)").match(data, pos)
        if not m:
            raise ValueError("truncated PNM header")
        tokens.append(m.group(2))
        pos = m.end()
    return tokens, pos


def read_pgm(path: str) -> np.ndarray:
    """Read P2/P5 PGM or P3/P6 PPM; returns uint8 grayscale [H, W].

    Color inputs are converted with the integer coefficients; maxval
    other than 255 is rescaled (pgmread.cpp:64-120).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    (magic,), pos = _read_header_tokens(data, 1)
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"unsupported PNM type {magic!r}")
    toks, pos = _read_header_tokens(data, 4)
    magic, w, h, maxval = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
    channels = 3 if magic in (b"P3", b"P6") else 1

    if magic in (b"P5", b"P6"):
        # binary: exactly one whitespace byte after maxval
        raw = data[pos + 1:]
        if maxval < 256:
            arr = np.frombuffer(raw[:w * h * channels], np.uint8)
        else:
            arr = np.frombuffer(raw[:w * h * channels * 2],
                                ">u2").astype(np.uint32)
    else:
        vals = data[pos:].split()
        arr = np.array([int(v) for v in vals[:w * h * channels]], np.uint32)

    arr = arr.reshape(h, w, channels) if channels == 3 else arr.reshape(h, w)
    if maxval != 255:
        arr = (arr.astype(np.uint64) * 255 // maxval)
    arr = arr.astype(np.uint8)
    if channels == 3:
        arr = rgb_to_gray(arr)
    return arr


def write_pgm(path: str, img: np.ndarray, scaled: bool = False):
    """Write a P5 PGM. With ``scaled``, float input is min/max-rescaled to
    0..255 (write_plane_2d.cu scaled variant); otherwise values are
    clamped."""
    if img.dtype != np.uint8:
        f = img.astype(np.float64)
        if scaled:
            lo, hi = f.min(), f.max()
            f = (f - lo) / (hi - lo + 1e-30) * 255.0
        img = np.clip(f, 0, 255).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P5\n{w} {h}\n255\n".encode())
        fh.write(img.tobytes())


def load_image(path: str) -> np.ndarray:
    """Load any supported image as uint8 grayscale [H, W]."""
    lower = path.lower()
    if lower.endswith((".pgm", ".ppm", ".pnm")):
        try:
            from ..runtime import native
            return native.read_pnm(path)
        except ImportError:
            # no toolchain / incompatible prebuilt library: the Python
            # codec below is the always-available semantics reference
            return read_pgm(path)
    try:
        from PIL import Image  # optional
        img = np.asarray(Image.open(path))
        if img.ndim == 3:
            img = rgb_to_gray(img[..., :3])
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return img
    except ImportError:
        pass
    try:
        import cv2  # optional fallback (JPEG/PNG/TIFF/...; the
        # reference's analogous optional loader is DevIL,
        # src/application/CMakeLists.txt:16-29)
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError(f"cannot decode {path}")
        return img.astype(np.uint8)
    except ImportError as e:
        raise ValueError(
            f"cannot read {path}: only PGM/PPM supported without "
            f"PIL or OpenCV") from e
