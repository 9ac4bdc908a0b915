"""Pure-NumPy scalar SIFT oracle used as the golden reference for the
port's tests and for ``chip_smoke.py`` (a copy of
:mod:`popsift_tpu.oracle`; it imports no torch)."""

from .sift_oracle import (
    oracle_pyramid,
    oracle_extrema,
    oracle_orientations,
    oracle_descriptor_grid,
    oracle_descriptor_loop,
    oracle_extract,
)

__all__ = [
    "oracle_pyramid",
    "oracle_extrema",
    "oracle_orientations",
    "oracle_descriptor_grid",
    "oracle_descriptor_loop",
    "oracle_extract",
]
