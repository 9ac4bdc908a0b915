"""Build the CUDA kernels in ``popsift_tpu_torch/csrc/`` into one shared
library with a plain C interface, loaded with ctypes.

``nvcc`` runs at first use, never at import: the library is cached in
``popsift_tpu_torch/_build/`` under a hash of the sources and flags, so
it is rebuilt only when a kernel source changes. No PyTorch headers are
involved, which keeps a cold build to seconds.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``-fmad=false``. The last stops
nvcc from contracting ``a*b + c`` into one fused multiply-add, so the
refine and histogram kernels round after every multiply exactly as the
JAX package's f32 algebra and the plain PyTorch versions do. No
``--use_fast_math``: divisions and square roots stay IEEE.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc run of this process, if any

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C signatures (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    # src, src_stride, blur, blur_stride, dog, dog_stride, N, H, W, taps,
    # S, stream
    "ps_blur_dog": (_VP, _LL, _VP, _LL, _VP, _LL, _I, _I, _I, _VP, _I, _VP),
    # dog, out, D, H, W, thr1, stream
    "ps_extrema_mask": (_VP, _VP, _I, _I, _I, _F, _VP),
    # dog, out, F, D, H, W, thr1, stream
    "ps_extrema_mask_batched": (_VP, _VP, _I, _I, _I, _I, _F, _VP),
    # dog, x0, y0, z0, n, D, H, W, maxlevel, vlfeat, out, stream
    "ps_refine": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP),
    # dog, x0, y0, z0, n_found, F, cap, D, H, W, maxlevel, vlfeat, out,
    # stream
    "ps_refine_batched": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                          _I, _VP, _VP),
    # blur, L, H, W, x, y, sigma, level, valid, n, out, stream
    "ps_orientation_hist": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _I,
                            _VP, _VP),
    # blur, L, H, W, x, y, sigma, level, ang, valid, n, radius, out, stream
    "ps_descriptor_loop": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                           _I, _I, _VP, _VP),
}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return nvcc


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Path of the built library, running nvcc if it is not cached."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libpopsift_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)     # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library with its argtypes set (built once per
    process, at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Validate the tensors a kernel reads or writes: all CUDA, all on
    one device, all contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
