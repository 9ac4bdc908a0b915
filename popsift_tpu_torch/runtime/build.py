"""Build the native host runtime (native/popsift_host.cpp) into a cached
shared library.

The port's own copy of :mod:`popsift_tpu.runtime.build`. Invoked lazily
on first import of :mod:`popsift_tpu_torch.runtime.native`; the compiled
.so is cached in ``popsift_tpu_torch/_build/`` keyed by a content hash so
rebuilds only happen when the C++ changes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.normpath(os.path.join(_HERE, "..", "..", "native",
                                     "popsift_host.cpp"))
_CACHE_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))


def source_path() -> str:
    return _SRC


def lib_path() -> str | None:
    """Return the path of the built library, building if needed.
    Returns None when no C++ toolchain is available."""
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(_CACHE_DIR, exist_ok=True)
    out = os.path.join(_CACHE_DIR, f"libpopsift_host_{digest}.so")
    if os.path.exists(out):
        return out

    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    # build to a temp file then atomically rename (concurrent importers)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
    os.close(fd)
    cmd = [cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"native runtime build failed:\n{e.stderr.decode()}") from e
    # drop stale builds
    for name in os.listdir(_CACHE_DIR):
        if (name.startswith("libpopsift_host_") and name.endswith(".so")
                and os.path.join(_CACHE_DIR, name) != out):
            try:
                os.unlink(os.path.join(_CACHE_DIR, name))
            except OSError:
                pass
    return out
