"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each module holds one kernel's wrapper, its plain PyTorch version and a
``launches`` counter. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel (adding one to ``launches``)
or raises. There is no other switch between the two.
"""

from . import desc, extrema_mask, orient, refine

KERNELS = (extrema_mask, refine, orient, desc)


def reset_launch_counts() -> None:
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict:
    return {mod.NAME: mod.launches for mod in KERNELS}
