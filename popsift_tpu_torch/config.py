"""Runtime configuration, shared with the JAX package.

:mod:`popsift_tpu.config` is plain Python (it imports no jax), so the
port uses the very same ``SiftConfig`` and constants: one configuration
object drives both packages, which is what the parity tests rely on.
"""

from popsift_tpu.config import (  # noqa: F401
    DESC_BINS,
    DESC_MAGNIFY,
    ORI_NBINS,
    ORI_WINFACTOR,
    ORIENTATION_MAX_COUNT,
    SiftConfig,
)
