#!/usr/bin/env python3
"""The card check of popsift_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: the CUDA kernels (popsift_tpu_torch/csrc/*.cu) built with
   nvcc from this checkout, and the build time;
3. the card tests: ``python -m pytest -q --noconftest -m cuda`` over
   ``tests/test_torch_*_cuda.py``. README.md ("On the card") says which
   file holds which surface. Their exit code is the script's.

The last line is a JSON object: ``ok`` (the tests passed) and the device.

Timing lives elsewhere: ``benchmark/`` measures every cell end to end and
per layer, ``popsift_tpu_torch/tools/kernel_times.py`` each kernel alone.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# The roofline arithmetic of the kernels' bounds. benchmark/harness/bounds.py
# keeps a copy, and benchmark/tests/test_bench_frames.py imports these six
# names from here to hold the two equal: keep them until that test is
# pointed elsewhere.
# NVIDIA's data sheet for the H100 SXM: device memory rate and the f32
# rate outside the tensor cores (every kernel here is plain f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``n_bytes`` (each input read once, each output written once)
    or to do ``n_ops`` f32 operations, whichever is larger."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def refine_bound(n_live: int, n_rows: int) -> tuple:
    """K2's bound: a live candidate's coordinates and 27 neighbours read
    at least once and its 16-float state written (every capacity row is
    written); about 150 operations for one step, which every candidate
    needs (how many of the five steps each took is not counted)."""
    return bound_ms(n_live * (12 + 27 * 4) + n_rows * 64, n_live * 150)


def ori_bound(sigma: torch.Tensor, n_rows: int) -> tuple:
    """K3's bound for valid rows of scale ``sigma``: a row's window of
    radius r = round(4.5 sigma) with its gradient margin read once, its 36
    bins written (every row); about 40 operations a pixel (gradient,
    sqrt, atan2, exp, bin)."""
    rad = torch.round(sigma * 4.5)
    return bound_ms(float(((2 * rad + 3) ** 2).sum()) * 4 + n_rows * 36 * 4,
                    float(((2 * rad + 1) ** 2).sum()) * 40)


def desc_bound(sigma: torch.Tensor, radius: int, n_rows: int) -> tuple:
    """K4's bound for valid jobs of scale ``sigma``: a job's support of
    half-side s = ceil(2.5 sqrt(2) 3 sigma) + 2 (at most the static
    radius) with its gradient margin read once, its 128 bins written
    (every row); about 90 operations a pixel (gradient, sqrt, atan2, exp
    and the rotation 40, eight tile weights 24, eight bin updates 24)."""
    sup = (torch.ceil(sigma * (3.0 * 2.5 * 2.0 ** 0.5)) + 2).clamp(max=radius)
    return bound_ms(float(((2 * sup + 3) ** 2).sum()) * 4 + n_rows * 128 * 4,
                    float(((2 * sup + 1) ** 2).sum()) * 90)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_phase(dev) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[dev.index or 0], flush=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(dev)} "
        f"(count {torch.cuda.device_count()})")


def build_phase() -> None:
    from popsift_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    took = time.perf_counter() - t0
    say(f"build: {len(build.sources())} sources, nvcc "
        f"{'%.1f s' % build.build_seconds if build.build_seconds else 'cached'}"
        f", load {took:.1f} s")


def card_tests() -> int:
    """The cuda-marked tests, in a process of their own: their exit
    code."""
    files = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tests", "test_torch_*_cuda.py")))
    cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-m",
           "cuda", "-p", "no:cacheprovider", *files]
    say(" ".join(cmd[1:]))
    return subprocess.run(cmd, cwd=REPO).returncode


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    say("phase 1: card")
    card_phase(dev)
    say("phase 2: build")
    build_phase()
    say("phase 3: the card tests")
    rc = card_tests()
    print(json.dumps({"ok": rc == 0, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
