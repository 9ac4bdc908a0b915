"""Compile a CUDA kernel source of ``popsift_tpu_torch/csrc`` for the CPU.

A CUDA kernel has no interpret mode, and a machine without a card has no
``nvcc``. This module builds a source with ``g++`` against a small
stand-in for ``cuda_runtime.h`` (``tools/host_mock/cuda_runtime.h``: one
``std::thread`` per CUDA thread, barriers for ``__syncthreads`` and the
warp shuffles) so that its indexing and arithmetic can be held against
the plain PyTorch version before any time on a card is spent:

    lib = ctypes.CDLL(host_mock.build("blur_dog"))
    lib.ps_blur_dog(...)        # pointers of CPU tensors, stream None

``-ffp-contract=off`` mirrors the ``-fmad=false`` of the real build, so
results that are bit-equal on the card are bit-equal here. The two
preprocessing steps are textual: ``kernel<<<grid, block, smem,
stream>>>(args);`` becomes a call of the stand-in's ``mock_launch`` and
``extern __shared__ T name[];`` a pointer into its buffer. Blocks run one
after another, so this says nothing about races between blocks or about
speed; ``tests/test_torch_kernels_host.py`` uses it for K1, K3, K4 and
K5, ``tests/test_torch_match_kernel.py`` for the matcher (its cp.async
copies through ``tools/host_mock/cuda_pipeline_primitives.h``, a copy
made at once).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_TOOLS = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_TOOLS)
CSRC = os.path.join(_PKG, "csrc")
MOCK_INCLUDE = os.path.join(_TOOLS, "host_mock")
BUILD_DIR = os.path.join(_PKG, "_build", "host_mock")
FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-w")


def find_compiler() -> str | None:
    return shutil.which("g++")


def rewrite(source: str) -> str:
    """The two textual steps: launches and dynamic shared memory."""
    def launch(m):
        grid, block, smem = [p.strip() for p in m.group(2).split(",")][:3]
        return (f"mock_launch(dim3({grid}), dim3({block}), {smem}, "
                f"[&]{{ {m.group(1)}({m.group(3)}); }});")

    source = re.sub(r"([\w:]+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", launch,
                    source, flags=re.S)
    return re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)mock_dyn_smem;", source)


def build(name: str, defines: tuple = ()) -> str:
    """Path of the host library of ``csrc/<name>.cu``, built if it is
    not cached under a hash of the source, the stand-ins and ``defines``
    (``NAME=value`` macros given to the compiler)."""
    cxx = find_compiler()
    if cxx is None:
        raise RuntimeError("g++ not found")
    with open(os.path.join(CSRC, f"{name}.cu")) as fh:
        text = rewrite(fh.read())
    flags = [*FLAGS, *(f"-D{d}" for d in defines)]
    h = hashlib.sha256((text + " ".join(flags)).encode())
    for header in sorted(os.listdir(MOCK_INCLUDE)):
        with open(os.path.join(MOCK_INCLUDE, header), "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        cpp = os.path.join(tmp, f"{name}.cpp")
        with open(cpp, "w") as fh:
            fh.write(text)
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([cxx, *flags, f"-I{MOCK_INCLUDE}", "-o", lib,
                              cpp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cu:\n{res.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out
