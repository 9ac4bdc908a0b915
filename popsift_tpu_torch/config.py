"""Runtime configuration of the PyTorch port.

The port's own copy of :mod:`popsift_tpu.config`, field for field and
default for default (tests/test_torch_imports.py holds the two
together): the port imports nothing of the JAX package. The static-shape
knobs keep their meaning here, since the port pads to the same
capacities.

Semantically mirrors the reference runtime parameter surface
(``popsift::Config``, sift_conf.h:28-310 and
sift_conf.cu:17-50) while being a frozen dataclass so it can key jit caches.

Differences from the reference (all deliberate, inherited from the JAX package):

* No CUDA device probing in the constructor.
* ``extrema_capacity`` replaces dynamic ``reallocExtrema``: XLA needs static
  shapes, so each octave detects into a fixed-capacity, validity-masked
  buffer (the reference itself clamps to ``max_extrema``,
  s_extrema.cu:551-561 — we just make the bound explicit per octave).
* Enum values are strings for ergonomic Python use; the accepted names are
  exactly the reference CLI vocabulary (sift_conf.cu:62-101).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

MAX_OCTAVES = 20  # sift_conf.h:13
MAX_LEVELS = 10   # sift_conf.h:14
GAUSS_ALIGN = 32  # sift_constants.h:33 (max half-span of a filter + 1)
ORI_NBINS = 36          # sift_constants.h (orientation histogram bins)
ORI_WINFACTOR = 1.5     # sift_constants.h
ORIENTATION_MAX_COUNT = 4  # sift_constants.h:46-52
DESC_BINS = 8           # angle bins per descriptor tile
DESC_MAGNIFY = 3.0      # SBP = 3 * sigma

GAUSS_MODES = (
    "vlfeat",               # VLFeat_Compute (default)
    "vlfeat-relative",      # VLFeat_Relative ("relative"/"vlfeat-hw-interpolated")
    "vlfeat-relative-all",  # VLFeat_Relative_All ("vlfeat-direct")
    "opencv",               # OpenCV_Compute
    "fixed9",
    "fixed15",
)

SIFT_MODES = ("popsift", "opencv", "vlfeat")

SCALING_MODES = ("indirect", "direct")  # ScaleDefault, ScaleDirect

# Octave-to-octave downscale: "pick" = get_by_2_pick_every_second (all
# reference SiftModes, s_pyramid_build.cu:232); "interpolate" =
# get_by_2_interpolate (s_pyramid_build.cu:33-49, the switch's default
# branch — reads the linear texture at (2x+1, 2y+1), which degenerates
# to picking pixel (2x+1, 2y+1) exactly).
DOWNSCALE_MODES = ("pick", "interpolate")

DESC_MODES = ("loop", "iloop", "grid", "igrid", "notile")

NORM_MODES = ("rootsift", "classic")

GRID_FILTER_MODES = ("random", "largest", "smallest")  # sift_conf.h:77-81


def _canon_gauss_mode(name: str) -> str:
    """Accept the reference CLI spellings (sift_conf.cu:83-101)."""
    aliases = {
        "vlfeat": "vlfeat",
        "vlfeat-hw-interpolated": "vlfeat-relative",
        "relative": "vlfeat-relative",
        "vlfeat-relative": "vlfeat-relative",
        "vlfeat-direct": "vlfeat-relative-all",
        "vlfeat-relative-all": "vlfeat-relative-all",
        "opencv": "opencv",
        "fixed9": "fixed9",
        "fixed15": "fixed15",
    }
    if name not in aliases:
        raise ValueError(f"bad gauss mode {name!r}; one of {sorted(set(aliases))}")
    return aliases[name]


@dataclass(frozen=True)
class SiftConfig:
    """All runtime parameters of the extraction pipeline.

    Defaults follow the reference exactly (sift_conf.cu:17-39):
    octaves auto, 3 levels, sigma 1.6, edge limit 10, threshold 0.04,
    2x upscale, 100k max extrema, initial blur 0.5 assumed.
    """

    octaves: int = -1          # -1: auto = floor(log2(min(w,h))) - 3 + 2^upscale
    levels: int = 3            # DoG levels searched; gauss levels = levels + 3
    sigma: float = 1.6
    edge_limit: float = 10.0
    threshold: float = 0.04
    upscale_factor: float = 1.0   # image stretched by 2^upscale_factor
    gauss_mode: str = "vlfeat"
    sift_mode: str = "popsift"
    scaling_mode: str = "indirect"
    downscale_mode: str = "pick"
    desc_mode: str = "loop"
    norm_mode: str = "rootsift"
    norm_multiplier: int = 0      # descriptor scaled by 2^norm_multiplier
    assume_initial_blur: bool = True
    initial_blur: float = 0.5
    max_extrema: int = 100000
    filter_max_extrema: int = -1  # grid filter budget; -1 disables
    filter_grid_size: int = 2
    grid_filter_mode: str = "largest"   # reference default is "random";
    # we default to the deterministic variant (reference docs call random
    # unstable, sift_conf.h:72-76); set "random" for exact parity testing.
    # Orientation-histogram smoothing: "vlfeat" (3x two circular box-3
    # passes — the reference's compile-time default WITH_VLFEAT_SMOOTHING,
    # s_orientation.cu:31-34,142-156) or "opencv" (one binomial
    # [1 4 6 4 1]/16 pass — the #else branch, s_orientation.cu:157-176).
    # The reference picks this at COMPILE time independent of sift_mode;
    # here it is a runtime knob with the same default.
    ori_smoothing: str = "vlfeat"
    verbose: bool = False

    # --- static-shape knobs (no reference equivalent) ---
    # Per-octave initial-extrema capacity. -1: auto-size from octave area.
    extrema_capacity: int = -1
    # Cap for the auto-sizing rule, keeps worst-case padded compute bounded.
    extrema_capacity_cap: int = 16384
    # Per-128-lane-block candidate clamp in the rank compaction
    # (ops/extrema.py::_compact_mask). 0: auto-scale from capacity/mask
    # density. Candidates dropped by this clamp are reported in
    # SiftFeatures.octave_dropped.
    compact_block_k: int = 0
    # Compute dtype for the pyramid ("float32" strongly recommended).
    dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "gauss_mode", _canon_gauss_mode(self.gauss_mode))
        if self.sift_mode not in SIFT_MODES:
            raise ValueError(f"bad sift mode {self.sift_mode!r}")
        if self.desc_mode not in DESC_MODES:
            raise ValueError(f"bad desc mode {self.desc_mode!r}")
        if self.norm_mode not in NORM_MODES:
            raise ValueError(f"bad norm mode {self.norm_mode!r}")
        if self.grid_filter_mode not in GRID_FILTER_MODES:
            raise ValueError(f"bad grid filter mode {self.grid_filter_mode!r}")
        if self.ori_smoothing not in ("vlfeat", "opencv"):
            raise ValueError(f"bad ori smoothing {self.ori_smoothing!r}")
        if self.scaling_mode not in SCALING_MODES:
            raise ValueError(f"bad scaling mode {self.scaling_mode!r}")
        if self.downscale_mode not in DOWNSCALE_MODES:
            raise ValueError(f"bad downscale mode {self.downscale_mode!r}")
        if self.levels < 2:
            # reference: levels = max(2, levels), popsift.cpp:71
            object.__setattr__(self, "levels", 2)
        if self.levels > MAX_LEVELS - 3:
            raise ValueError(f"levels > {MAX_LEVELS - 3} not supported")
        if self.gauss_mode in ("fixed9", "fixed15") and self.levels != 3:
            # the reference's fused fixed-span octave code supports
            # exactly 6 gauss levels (s_pyramid_fixed.cu:269-288 POP_FATAL)
            raise ValueError(
                "fixed9/fixed15 gauss modes require levels=3 "
                "(6 gauss levels, s_pyramid_fixed.cu:269-288)")
        if self.sigma > 2.0:
            # gauss_filter.cu:131-137 rejects sigma > 2.0
            raise ValueError("sigma > 2.0 is not supported")

    # -- derived quantities ------------------------------------------------

    @property
    def total_levels(self) -> int:
        """Gauss-blurred layers per octave (levels + 3, sift_pyramid.cu:112)."""
        return self.levels + 3

    @property
    def peak_threshold(self) -> float:
        """Actual DoG contrast threshold.

        Reference formula: threshold * 0.5 * 255 / levels
        (sift_conf.cu:275-278) — the 255 accounts for the pyramid being
        stored in 0..255 scale (s_pyramid_build_ra.cu:54 writes out*255).
        """
        return self.threshold * 0.5 * 255.0 / self.levels

    @property
    def sigma_k(self) -> float:
        """Scale step between levels: 2^(1/levels) (sift_constants.cu:27)."""
        return 2.0 ** (1.0 / self.levels)

    @property
    def scaled_initial_blur(self) -> float:
        """Initial blur in upscaled-image coordinates (gauss_filter.cu:169-171)."""
        if not self.assume_initial_blur:
            return 0.0
        return self.initial_blur * (2.0 ** self.upscale_factor)

    @property
    def max_orientations(self) -> int:
        """Flat feature-vector capacity (sift_constants.cu:31: max + max/4)."""
        return self.max_extrema + self.max_extrema // 4

    def num_octaves_for(self, width: int, height: int) -> int:
        """Auto octave count (popsift.cpp:107-111).

        max(floor(log2(min(w,h))) - 3 + 2^upscale, 1), using the *input*
        dimensions (before upscaling).
        """
        if self.octaves > 0:
            return min(self.octaves, MAX_OCTAVES)
        scale_factor = 2.0 ** self.upscale_factor
        oct_ = int(math.floor(math.log(min(width, height)) / math.log(2.0))
                   - 3.0 + scale_factor)
        return max(min(oct_, MAX_OCTAVES), 1)

    def octave_dims(self, width: int, height: int) -> list[tuple[int, int]]:
        """(height, width) of every octave.

        Octave 0 is ceil(dim * 2^upscale); each next octave is
        ceil(prev / 2) (popsift.cpp:115-117, sift_pyramid.cu:131-133).
        """
        s = 2.0 ** self.upscale_factor
        w = math.ceil(width * s)
        h = math.ceil(height * s)
        dims = []
        for _ in range(self.num_octaves_for(width, height)):
            dims.append((h, w))
            w = math.ceil(w / 2.0)
            h = math.ceil(h / 2.0)
        return dims

    def capacity_for_octave(self, oct_h: int, oct_w: int) -> int:
        """Static initial-extrema capacity for an octave of the given size."""
        if self.extrema_capacity > 0:
            return min(self.extrema_capacity, self.max_extrema)
        auto = max(512, (oct_h * oct_w) // 128)
        return int(min(auto, self.extrema_capacity_cap, self.max_extrema))

    def replace(self, **kw) -> "SiftConfig":
        return dataclasses.replace(self, **kw)
