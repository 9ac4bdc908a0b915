"""Build the CUDA kernels in ``popsift_tpu_torch/csrc/`` into one shared
library with a plain C interface, loaded with ctypes.

``nvcc`` runs at first use, never at import: the library is cached in
``popsift_tpu_torch/_build/`` under a hash of the sources and flags, so
it is rebuilt only when a kernel source changes. Every source compiles
to its own object in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links them. No PyTorch headers are involved, which
keeps a cold build to seconds.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``-fmad=false``. The last stops
nvcc from contracting ``a*b + c`` into one fused multiply-add, so the
refine and histogram kernels round after every multiply exactly as the
JAX package's f32 algebra and the plain PyTorch versions do. No
``--use_fast_math``: divisions and square roots stay IEEE.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` calls one under its tensors' device guard and raises when
that is not 0.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc run of this process, if any

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C signatures (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    # src, src_stride, blur, blur_stride, blur_lstride, dog, dog_stride,
    # dog_lstride, pick, pick_stride, OH, OW, pick_level, N, H, W, taps,
    # spans, n, T, stream
    "ps_blur_chain": (_VP, _LL, _VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL, _I,
                      _I, _I, _I, _I, _I, _VP, _VP, _I, _I, _VP),
    # N, H, W, Scum -> tile side (0: the halo does not fit)
    "ps_blur_chain_tile": (_I, _I, _I, _I),
    # vol, cy, cx, n_valid, K, D, H, W, radius, rows, cols, out, stream
    "ps_extract_windows": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                           _VP, _VP),
    # vol, cy, cx, n_found, F, cap, D, H, W, radius, rows, cols, out, stream
    "ps_extract_windows_batched": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _VP, _VP),
    # patches, P, PL, H, W, y0, x0, x, y, sigma, ang, valid, n, out, stream
    "ps_descriptor_loop_patches": (_VP, _I, _I, _I, _I, _VP, _VP, _VP, _VP,
                                   _VP, _VP, _VP, _I, _VP, _VP),
    # src, src_stride, blur, blur_stride, dog, dog_stride, pick,
    # pick_stride, OH, OW, N, H, W, taps, S, stream
    "ps_blur_dog": (_VP, _LL, _VP, _LL, _VP, _LL, _VP, _LL, _I, _I, _I, _I,
                    _I, _VP, _I, _VP),
    # table (host i64[n_oct, 4]), n_oct, N, L, pick_level, taps, spans, stream
    "ps_blur_dog_thin": (_VP, _I, _I, _I, _I, _VP, _VP, _VP),
    # table (host i64[n_oct, 5]), n_oct, F, thr1, stream
    "ps_extrema_mask_octaves": (_VP, _I, _I, _F, _VP),
    # dog, x0, y0, z0, n, D, H, W, maxlevel, vlfeat, out, stream
    "ps_refine": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP),
    # dog, x0, y0, z0, n_found, F, cap, D, H, W, maxlevel, vlfeat, out,
    # stream
    "ps_refine_batched": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                          _I, _VP, _VP),
    # table (host i64[n_oct, 7]), n_oct, F, x0, y0, z0, n_found, maxlevel,
    # vlfeat, out, stream
    "ps_refine_octaves": (_VP, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _VP, _VP),
    # table (host i64[n_oct, 15]), n_oct, F, rows, scratch, x0, y0, z0,
    # n_found, n_dropped, stream
    "ps_compact_octaves": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                           _VP),
    # table (host i64[n_oct, 8]), n_oct, n_rows, frame_rows, x, y, sigma,
    # level, valid, out, stream
    "ps_orientation_hist_octaves": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                                    _VP, _VP),
    # blur, L, H, W, x, y, sigma, level, ang, valid, n, radius, out, stream
    "ps_descriptor_loop": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                           _I, _I, _VP, _VP),
    # table (host i64[n_oct, 8]), n_oct, x, y, sigma, level, ang, valid,
    # radius, out, stream
    "ps_descriptor_loop_octaves": (_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                                   _VP, _VP),
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


def _run_together(cmds: list) -> None:
    """Start every command at once and wait for all; raise with the
    output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    texts = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, texts):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")


def library_path() -> str:
    """Path of the built library, running nvcc if it is not cached."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libpopsift_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources()]
        _run_together([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                       for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_together([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)     # atomic: concurrent builds agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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


def launch(name: str, t, fn, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` under ``t``'s device guard,
    with PyTorch's current stream on that device as the stream, and raise
    when it reports a CUDA error. The C entries launch on the calling
    thread's current device, so without the guard a kernel given tensors
    on ``cuda:1`` while ``cuda:0`` is current would run on the wrong card
    with foreign pointers."""
    import torch
    with torch.cuda.device(t.device):
        rc = fn(*args, stream_of(t))
    check(rc, name)


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
