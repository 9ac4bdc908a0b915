"""What the card tests (``tests/test_torch_*_cuda.py``) share: the bench
frame's size and counts, the golden tolerances, the card's set-up, the
sync guard, the row error, the matcher's planted ties and tolerances,
the per-octave chain and the kernel entries each extraction path launches.

The card files import this module by name (pytest puts ``tests/`` on
``sys.path``; the ranks of ``test_torch_parallel_cuda.py`` inherit it).
Like them it imports no jax and nothing of ``popsift_tpu``: the card's
machine has neither, and its tests run with ``--noconftest``.
"""

import pytest
import torch

# bench.make_frame at 1920 x 1080, seeds 0-3, with
# SiftConfig(extrema_capacity=8192): frame 0 gives 2110 keypoints and
# 2505 descriptors with no candidate dropped
FRAME_HW = (1080, 1920)
N_FRAMES = 4
BENCH_KEYPOINTS, BENCH_DESCRIPTORS = 2110, 2505
GOLDEN_TOL = dict(x=5e-3, y=5e-3, sigma=1e-3, ori=1e-3, desc=6e-3)
# the share of a pair's matches (or of a matcher's valid left rows) by
# which the card may differ from the CPU: near-ties decided by rounding
PAIR_NEAR_TIE = 0.005

# kernel entries of the main path (one frame or a batch)
MAIN_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves", "compact",
             "refine_octaves", "orientation_hist_octaves",
             "descriptor_loop_octaves")
# the launches over all octaves (and frames): exactly once on every
# extraction path (K2's on the fused route)
FUSED_ONCE = ("extrema_mask_octaves", "compact", "orientation_hist_octaves",
              "descriptor_loop_octaves", "refine_octaves")
# the calibration probe detects only
PROBE_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves", "compact")
# the spatially sharded extraction: K2-K4 take row bounds
BOUNDED = ("refine_octaves_bounded", "orientation_hist_octaves_bounded",
           "descriptor_loop_octaves_bounded")
SPATIAL_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves",
                "compact") + BOUNDED


def card_device(reason: str = "the kernels run only on the card"):
    """The card, with TF32 off (matmuls and ``F.conv2d`` in full f32);
    skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA device: {reason}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def without_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    synchronising call raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def tie_case(case):
    """The matcher's planted ties, the data of
    ``tests/test_torch_matching.py::_tie_case`` (numpy arrays dl f32[12,
    128], vl, dr f32[37, 128], vr): integer-valued descriptors, so every
    distance is exact and equal distances are exact ties. Right rows
    8..15 are invalid; ``dupes`` repeats rows across tiles of 8; ``one``
    and ``none`` leave one valid right row and none."""
    import numpy as np
    rng = np.random.default_rng(7)
    dl = rng.integers(0, 3, (12, 128)).astype(np.float32)
    dr = rng.integers(0, 3, (37, 128)).astype(np.float32)
    dr[20] = dr[3]
    dr[33] = dr[3]
    dr[30] = dl[5]
    dr[35] = dl[5]
    dl[7] = dl[5]
    vl = np.ones(12, bool)
    vl[10] = False
    vr = np.ones(37, bool)
    vr[8:16] = False
    if case == "one":
        vr[:] = False
        vr[30] = True
    elif case == "none":
        vr[:] = False
    return dl, vl, dr, vr


# unit descriptors: a kernel's d2 sums its products in another order than
# the plain version's (cuBLAS's, or the CPU's), a few 1e-6 apart and under
# 3e-5 by the bound of 128 rounded terms
MATCH_DIST_TOL = 1e-4


def match_differences(got, want, dl, dr, valid_l, ratio: float = 0.8) -> int:
    """Hold a matcher's ``MatchResult`` to the plain version's of the same
    sets: finite distances within ``MATCH_DIST_TOL`` and the infinite
    ones equal; every row whose best or second column differs a near-tie
    (the f64 distances of the two columns within 2 x ``MATCH_DIST_TOL``);
    every row whose accept differs with equal columns a ratio near-tie
    (``|best - ratio x second|`` of the plain result within 2 x
    ``MATCH_DIST_TOL``). Returns how many valid left rows differ."""
    g = [f.cpu() for f in got]
    w = [f.cpu() for f in want]
    dl64, dr64 = dl.cpu().double(), dr.cpu().double()
    for k in (2, 3):
        fin = torch.isfinite(w[k])
        assert torch.equal(torch.isfinite(g[k]), fin), k
        if fin.any():
            gap = float((g[k][fin] - w[k][fin]).abs().max())
            assert gap <= MATCH_DIST_TOL, (k, gap)
    for k in (0, 1):
        rows = (g[k] != w[k]).nonzero().squeeze(1)
        if rows.numel():
            a = ((dl64[rows] - dr64[g[k][rows]]) ** 2).sum(1)
            b = ((dl64[rows] - dr64[w[k][rows]]) ** 2).sum(1)
            gap = float((a - b).abs().max())
            assert gap <= 2 * MATCH_DIST_TOL, (k, gap)
    cols = (g[0] != w[0]) | (g[1] != w[1])
    accept = g[4] != w[4]
    lone = accept & ~cols
    assert ((w[2] - ratio * w[3]).abs()[lone] <= 2 * MATCH_DIST_TOL).all()
    return int(((cols | accept) & valid_l.cpu()).sum())


def rel_row_err(got, ref) -> float:
    """max |got - ref| / (row max of |ref|) over rows with a non-zero
    reference, and max |got| over rows whose reference is all zero."""
    rowmax = ref.abs().amax(1, keepdim=True)
    err = (got - ref).abs()
    rel = torch.where(rowmax > 0, err / rowmax.clamp(min=1e-30), err)
    return float(rel.max()) if rel.numel() else 0.0


def launches_of(run) -> tuple:
    """``run()`` with every launch counter reset just before it; returns
    (its result, ``kernels.launch_counts()``). The counters count wrapper
    calls, which a CUDA graph's replay makes none of: count a plan's
    first (eager) call or its second (the capture)."""
    from popsift_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    out = run()
    return out, kernels.launch_counts()


def expected_launches(cfg, plan, batch: bool = False, detect: str = "fused",
                      front: str = "level") -> dict:
    """Launches per kernel entry of one eager extraction of ``cfg``: K5
    once per level of every wide octave it blurs (octave 0 of the fixed
    modes is plain torch), or on the chain front K7 once per group of
    ``CHAIN_GROUP`` levels of each wide octave; K5's thin entry once
    where the strategy allows it (incremental, pick every second pixel,
    indirect scaling); K1, the compaction and K3 once; K2 once on the
    fused route or K6 once per octave on the window route; K4 once for
    ``desc_mode="loop"`` (the other variants are plain torch); nothing
    else (the matcher's kernel runs once a match call, none here)."""
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops.pyramid import CHAIN_GROUP, first_thin_octave
    n_oct = len(plan.pyramid.dims)
    first = first_thin_octave(plan.pyramid)
    wide = first - (1 if cfg.gauss_mode in ("fixed9", "fixed15") else 0)
    want = dict.fromkeys(kernels.ENTRIES, 0)
    if front == "chain":
        want["blur_chain"] = wide * -(-(cfg.total_levels - 1) // CHAIN_GROUP)
    else:
        want["blur_dog"] = (cfg.total_levels - 1) * wide
    want.update({"blur_dog_thin": int(first < n_oct),
                 "extrema_mask_octaves": 1, "compact": 1,
                 "orientation_hist_octaves": 1,
                 "descriptor_loop_octaves": int(cfg.desc_mode == "loop")})
    if detect == "windows":
        want["extract_windows_batched" if batch else "extract_windows"] = \
            n_oct
    else:
        want["refine_octaves"] = 1
    return want


def per_octave_chain(frame: torch.Tensor, plan) -> list:
    """The JAX package's per-octave public names on each octave of
    ``frame``: ``build_pyramid_octaves``, then per octave
    ``detect_extrema``, ``assign_orientations``, ``make_descriptor_jobs``,
    ``compute_descriptors`` and ``normalize_descriptors``. Returns per
    octave (extrema, orientations, jobs, descriptors)."""
    from popsift_tpu_torch.ops.descriptors import (compute_descriptors,
                                                   normalize_descriptors)
    from popsift_tpu_torch.ops.pyramid import build_pyramid_octaves
    from popsift_tpu_torch.pipeline import (assign_orientations,
                                            detect_extrema,
                                            make_descriptor_jobs)
    cfg = plan.config
    out = []
    for o, (levels, dog_layers) in enumerate(
            build_pyramid_octaves(frame, plan.pyramid)):
        blur, dog = torch.stack(levels), torch.stack(dog_layers)
        H, W = plan.pyramid.dims[o]
        ext = detect_extrema(dog, cfg, plan.ext_caps[o], W, H)
        oris = assign_orientations(blur, ext, cfg)
        jobs = make_descriptor_jobs(ext, oris, plan.job_caps[o])
        desc = normalize_descriptors(compute_descriptors(blur, jobs, cfg),
                                     cfg)
        out.append((ext, oris, jobs, desc))
    return out
