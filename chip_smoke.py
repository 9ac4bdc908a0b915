#!/usr/bin/env python3
"""Smoke test of popsift_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Drives the port's main path on the card and checks it, phase by phase;
any failed phase raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: the CUDA kernels (popsift_tpu_torch/csrc/*.cu) built with
   nvcc from this checkout, and the build time;
3. each kernel against its plain PyTorch version on the same tensors, at
   the shapes the main path gives it on a 1920x1080 frame
   (``bench.make_frame``, seed 0): blur/DoG levels (K5) exact or within
   1e-4 on the 0..255 scale and its pick of every second pixel equal to
   the slice, masks exact (K1's one launch over all octaves, its
   single-octave entry and, on four frames, seeds 0-3, its batched entry
   and its one launch over all octaves of the batch); the compaction of
   all octaves' masks entry for entry equal to ``_compact_mask`` (rows,
   padding rows, ``n_found``, ``n_dropped``) on the frame, on the four
   frames and on a saturated plan (``extrema_capacity=256``); K2's one
   launch over all octaves bit-equal to its plain version and to its
   one-octave launches, on the frame and on the four frames (against its
   batched entry there); refinement state of the one-octave entries
   within 1e-5 with the accept masks exact, histograms and descriptors
   within 1e-5 x the row's max; K3's one launch over all octaves
   bit-equal to its single-octave launches and to a second run; the
   window copy K6 and its batched entry, exact; K5's one launch over the
   thin octaves (34 x 60 and smaller) bit-equal to its plain version and
   to the planes of the level launches; the chain front K7 on every
   octave, with its pick of level L-3 into the next octave's level 0,
   bit-equal to K5's planes and to its plain version, on the frame and
   on the four frames; K4's one launch over all octaves bit-equal to
   its single-octave launches and to a second run; the patch entry of K4
   on the densest octave's real jobs against its plain version and
   against K4, and the bucketed launches of K3 and K4 against the single
   launch on the same rows, within 1e-5 x the row's max; median time of
   kernel and plain over 20 runs, timed with CUDA events, and beside
   them the one PyTorch library call that computes the same function
   where there is one (two ``F.conv2d`` passes and a subtraction for K5
   and K7, one advanced-indexing gather for K6) and the least time the
   card could take (the bound, see :func:`bound_ms`);
4. the main path ``PopSift(SiftConfig(extrema_capacity=8192),
   device="cuda").enqueue(frame).get()`` with every launch counter reset
   just before it: 2110 keypoints / 2505 descriptors, no dropped
   candidate, every kernel of the path launched, K1, the compaction, K2,
   K3 and K4 exactly once (over all octaves) and their one-octave
   entries not at all; finite outputs; then ``extract`` of the frame
   already on the card under ``torch.cuda.set_sync_debug_mode("error")``
   (no synchronising call), equal to the enqueued run in every field, and
   one profiler pass of it (device ops, device busy time, host launch
   calls, stream syncs: 0, sorts: 0, launch calls under 700); the five
   golden scenes (tests/golden, the two defaults and the three variant
   configurations) within the golden tolerances; warm
   ms/frame of the kernel path and of the plain-PyTorch path on the
   card, and the counts of the ``SiftConfig()`` default;
5. the batch path ``enqueue_batch`` of the four frames, counters reset
   just before it: K5 once per level of the wide octaves and once for
   all thin octaves, K1, the compaction, K2, K3 and K4 once for the
   whole batch; each frame equal to its own ``enqueue`` (counts, masks
   and integer fields exact, float fields bit-equal or within 1e-6 x the
   field's magnitude); ``extract_batch`` of the frames on the card with
   the checks of phase 4; warm ms/frame of the batch against
   single-frame ``enqueue`` and the plain batch; then
   ``PopSift.calibrate([frame])`` with the counters reset just before it
   (its detect-only probe launches K5, K1 and the compaction, once over
   all octaves, and nothing else) and ``enqueue``: no octave saturates
   its calibrated capacity;
6. the other routes at full 1080p width, counters reset before each run:
   ``PopSift(cfg, device="cuda", detect="windows")`` ``.enqueue`` and
   ``.enqueue_batch`` (2110 / 2505 on frame 0, nothing dropped, K6 once
   per octave and K2 not at all, K1, the compaction, K3 and K4 once a
   run, every frame equal to its ``detect="fused"`` result);
   ``front="chain"`` the same way (K7 launched for every group of the
   wide octaves, K5's thin entry once, K5's level launches not); the
   entries that
   no extraction path calls (the patch entry of K4, the bucketed
   launches of K3 and K4 with their single-octave entries beneath them,
   the single-octave and batched entries of K1 and of K2, the latter
   held bit-equal to K2's all-octave launch) driven once on the densest
   octave's rows; warm ms/frame of each route, interleaved with the
   default route; one profiler pass of the level and the chain front in
   turns (level, chain, chain, level), single frame and four frames:
   launch calls, device ops, device busy time, the port's kernels'
   device time, and from it K3's and K4's device time for four times the
   jobs (whether they are bound by latency);
7. the match path: ``PopSift(cfg, mode="matching", device="cuda")``
   ``.enqueue`` of frame 0 and of its (3, 5) roll with the counters reset
   just before them (every kernel of the main path twice its phase-4
   count, nothing else), 2110 / 2505 on frame 0; the self-match (each
   valid row's best is itself, or an earlier row with a bit-identical
   descriptor, at distance < 1e-6); frame 0 against the roll and against
   seed 1 equal to the CPU run of the same matcher on the valid rows
   (near-ties at most 0.1 %, distances within 1e-4); the matcher with
   TF32 on equal to the run with it off; q8 equal to its CPU run, and q8
   and pruned keeping the exact matcher's nearest neighbour on >= 99 % of
   its accepted rows (pruned also its accepts); homography RANSAC on the
   accepted matches (>= 90 % of the matches that the known shift moves
   within 2 px are inliers, no inlier 2.5 px off it, the inliers' mean
   shift within 0.05 px, the model's corners within 0.5 px); essential
   RANSAC and ``solve_pairs_batch`` on seeded synthetic scenes, the card
   against the CPU from the same ranks; the match CLI with ``--device
   cuda --geom homography`` against the API; times (CUDA events, median
   of 10) of the exact matcher on the padded sets beside its bound and
   the ``cdist`` + ``topk`` library call, of q8, pruned and each RANSAC;
8. the extraction variants: each configuration of ``VARIANTS`` (the three
   golden variant configurations, ``sift_mode="opencv"``, direct
   scaling, vlfeat-relative-all, fixed15, ``upscale_factor=0`` and the
   grid filter at 1000 in its three orders) through ``enqueue`` of frame
   0 with ``extrema_capacity=8192``, and one through ``enqueue_batch`` of
   the four frames on the window route, with the counters reset just
   before it: the launches :func:`expected_launches` gives (K5's thin
   entry 0 where the strategy does not allow it, K4 0 for the
   plain-torch descriptor variants), each frame of ``enqueue`` equal to
   ``extract_batch``, the run equal to its ``plain=True`` run on the card
   (masks and counts exact, x, y and sigma bit-equal, orientations and
   descriptors within the golden tolerances) with K3's and K4's rows
   within 1e-5 x the row's max of their plain versions on the same
   inputs, the same run again under ``set_sync_debug_mode("error")``,
   and warm ms/frame (median of 5) beside the default configuration's;
   one variant on a 480 x 640 crop against the port's CPU run (golden
   tolerances); the plain-torch descriptor variants timed on the bench
   frame's jobs beside K4, with their bound; K1 on
   ``synthetic_image(1080, 1920)`` beside the bench frame; ms/frame of
   batches of 1, 2 and 8 frames;
9. the SfM geometry (``sfm/ba.py``, ``sfm/pnp.py``; plain PyTorch, no
   kernel of its own) at the size of the repo's BA benchmark problem:
   100 cameras on an arc round 40,000 points, each seen by 5 of them
   (200,000 observations), f = 500 on 640 x 480, the start perturbed as
   tests/test_sfm.py::_make_ba_problem perturbs it. One
   ``schur_dense_step`` and one ``schur_cg_step`` on the card against
   the port on the CPU: in f64, dc and dp within 1e-9 x the step's max;
   in f32, the cost within 1e-5 relative and the step within 1e-3 of the
   f64 step in the GN model's norm (|J d|^2 + lam |d|^2), the
   largest-entry gaps printed; ``bundle_adjust(iters=10)`` dense and CG:
   below 1e-4 of the start cost without noise, ATE at most 1e-3 x the
   trajectory's extent with 0.5 px noise and the final cost within 1e-3
   of the CPU's, Huber (5 % of the observations 80 px off) under a tenth
   of L2's ATE; the
   joint focal solve on tests/test_sfm.py's 8-camera scene against the
   CPU and within 0.5 % of the truth; ``bundle_adjust`` under
   ``set_sync_debug_mode("error")`` and twice (bit-equal or not,
   printed); ``ransac_pnp_batch`` at ``IncrementalSfM``'s shape (16
   images x 2048 rows, about 1500 valid, a quarter outliers) on the card
   against the CPU from the same ranks (R within 1e-4, t within 1e-4 x
   |t|, inlier masks equal off the gate's 1 % band and on at least 99.9
   % of the valid rows) and the truth, and its host syncs by source
   line; the times of each (CUDA events, median of 5) beside their
   bounds, with one profiler pass (launch calls, device ops, busy time,
   idle share);
10. the SfM drivers (``sfm/incremental.py``, ``sfm/global_sfm.py``; plain
   PyTorch and the host's numpy, no kernel of their own) on the scenes of
   ``popsift_tpu_torch/tools/sfm_scenes.py``: ``IncrementalSfM`` on the
   card against its CPU run on 5 cameras / 80 points (seed 7, 0.3 px;
   the same ranks drawn, the same seed pair with R2 / t2 within 1e-4, the
   same registration order and inlier counts, centers within 1e-3 x the
   extent after a similarity alignment once ``global_ba(iters=8)`` ran,
   ATE < 0.05 on both); 200 cameras / 1200 points (seed 13, 0.2 px,
   ``ba_every=25, register_batch=8``: at least 196 registered, the final
   BA's cost not rising, ATE < 0.5) with the time inside each device call
   (CUDA events, ``tools/sfm_scale.py``'s timer) and one profiler pass of
   a ``register_next`` (launch calls, busy time, idle share, host syncs by
   source line); 80 cameras with local BA (window 12: at least 76
   registered, ATE under 1 % of the extent, also after ``refine(2)``);
   ``global_sfm`` at 40 cameras (all registered, ATE < 0.5) with each
   ``solve_pairs_batch`` chunk timed and one of them profiled;
   ``translation_averaging_cg`` at 12,000 nodes (median error under 5 %
   of the spread), the dense and CG solves of a 24-node problem against
   each other (1e-2 x the scale) and against their CPU runs and the f64
   solve (5e-4 x the scale), rotation averaging of 30 nodes
   (median error under 0.5 deg, max under 3); checkpoint and resume on
   the card against an uninterrupted run (centers within 1e-3, the same
   point count); the wall time of each run;
11. popsift-sfm (``cli/sfm.py``, ``sfm/retrieval.py``; no kernel of their
   own) on the scene of the JAX package's E2E artifact
   (``tools/e2e_proof.py::render_sequence``: 100 frames of 240 x 320):
   (a) the frames' strongest descriptors extracted on the card,
   ``train_codebook``, ``build_signatures`` and ``pair_shortlist`` on the
   card against the CPU from the same sample and init scores (centers
   within 1e-4 x the largest entry, signatures within 1e-5, the shortlist
   equal pair for pair; ``top_k``'s tie order on the card), each timed;
   (b) ``cli.sfm.main`` with ``--device cuda --retrieval 8 --refine``
   and both exports, with every launch counter reset just before it:
   K1, the compaction, K2, K3 and K4 launched once a frame and K5's
   entries at least once, cameras.txt, images.txt, points3D.txt and the
   PLY written; the wall of each stage (from the times its ``-v`` lines
   were printed), one profiler pass of the middle ``register_next`` and
   of one pair of the matching loop; then the same command with
   ``--seed`` 1 to 6: the median of the seven runs at least
   ``E2E_MIN_REGISTERED`` of 100 registered and an ATE at most
   ``E2E_MAX_ATE_PCT`` % of the trajectory (see there why); (c)
   ``--global`` on the first 40 frames with ``--seed`` 0 to 6, held to
   the JAX CLI's result on a CPU: the median registered count at least
   JAX's minus 2, the best ATE at most twice JAX's or 5 % of the
   trajectory (see ``GLOBAL_SEEDS`` why); (d) the first 6 frames on the
   card and on the CPU with the same ``--seed``: equal keypoint and track
   counts, each pair's match count within 0.5 %, the same registered
   cameras;
12. the multi-device layer (``parallel/``, ``sfm/distributed.py``; no
   kernel of its own: each rank runs the main path's kernels): (a) world
   size 1 on NCCL, ``make_batched_extract_fn(match_pairs=True)`` of the
   four frames with every launch counter reset just before it: each
   kernel of the batch path launched as by ``extract_batch`` (K1, the
   compaction, K2, K3 and K4 once), the features bit-equal to
   ``extract_batch``, 2110 / 2505 on frame 0, the four ring pairs
   bit-equal to ``match_descriptors``, no stream sync under
   ``set_sync_debug_mode("error")``, ms/frame beside ``extract_batch`` in
   turns; (c) all-pairs over the frames' first ``AP_ROWS`` valid
   descriptors, every pair bit-equal to ``match_descriptors`` alone; (d)
   distributed BA at phase 9's size, dense and CG: the final cost within
   ``BA_COST_TOL`` of ``bundle_adjust``'s, the first f64 GN step within
   1e-9 x its max of the single-process f64 step, the LM loop with no
   host sync, ms beside ``bundle_adjust`` in turns; (e) edge-sharded
   rotation and translation averaging of ``AVG_NODES`` nodes: rotations
   within ``ROTATION_TOL`` of the single-process solve, the f64
   translations within ``TRANSLATION_F32_TOL`` x the scale (the f32 ones
   read, see ``_check_avg``); then (b)-(e) on two processes sharing the
   card on gloo (``parallel_rank``): each rank's kernels launched once
   for its two frames, the gathered features and ring pairs (1->2, 3->0
   across the ranks) against (a) by phase 5's rule, all-pairs equal to
   (a), BA and averaging as above, and the times of the host-staged
   collectives; (f) ``tools/dryrun_multichip.py`` at world size 2 on the
   card;
13. the spatially sharded extraction (``parallel/spatial.py``; no kernel
   of its own: each rank runs the main path's kernels on its band, K2,
   K3 and K4 through their entries with row bounds): (a) world size 1
   on NCCL, ``make_sharded_extract_fn`` of frames 0 and 1 with
   ``SiftConfig(extrema_capacity=8192)``, every launch counter reset
   just before it, equal in every field to ``extract`` at the effective
   capacities, 2110 / 2505 on frame 0 with no octave saturated or
   dropping, K5, its thin entry, K1, the compaction and the bounded K2,
   K3 and K4 launched (K1, the compaction and the bounded entries once,
   the unbounded K2-K4 not at all), 0 stream syncs under
   ``set_sync_debug_mode("error")``, peak memory and ms/frame in turns
   with ``extract``; the 4K frame ``bench.make_frame(2160, 3840)`` at
   ``CAPACITY_4K`` the same way; (b) world size 2 on gloo, both ranks on
   the card: frames 0-1 against (a) by phase 5's rule, each rank's
   sharded octaves, band candidates and drops, launches, collectives and
   their bytes, peak memory and ms/frame in turns with ``extract``; (d)
   the 4K frame the same way; (e) on the last rank the bounded launches
   of its band again against their plain versions (K2 bit-equal, K3 and
   K4 within 1e-5 x the row's max), with whole-stack bounds bit-equal to
   the unbounded launch, timed beside their bounds; (c) DP x SP, a (2, 2)
   mesh of four ranks on the card, frames 0-1 against (b); (f) phase
   12's run of ``tools/dryrun_multichip.py`` at world size 2 on the
   card, its spatial items (2, 2b) equal to ``extract``;
14. the port's copy of the NumPy oracle (``popsift_tpu_torch/oracle/``,
   run in ``ORACLE_WORKERS`` host processes while the card runs (c)) and
   the JAX package's per-octave public names: (a) the copy's
   ``oracle_extract`` on the five golden cases, each field's max
   difference from tests/golden printed and held within ``GOLDEN_TOL``;
   (b) ``PopSift(cfg, device="cuda")`` on the three ``ORACLE_SCENES``
   (240 x 320, outside the fixtures) against the copy by
   tests/test_pipeline.py:15-38's rule (equal counts, a greedy 1-1 match
   within 5e-3 px, sigma within 1e-3, equal orientation counts, each
   descriptor within ``GOLDEN_TOL["desc"]``); (c) on the bench frame,
   every launch counter reset just before it, ``build_pyramid_octaves``
   then per octave ``detect_extrema``, ``assign_orientations``,
   ``make_descriptor_jobs``, ``compute_descriptors`` and
   ``normalize_descriptors``: K1's, K3's and K4's one-octave entries and
   the compaction and K2's all-octave entry once an octave (K4 where the
   octave has jobs), the all-octave K1, K3 and K4 not at all; every
   octave's rows equal to ``extract``'s (masks, counts and positions
   exact, angles and descriptors within ``GOLDEN_TOL``, their largest
   differences printed), 2110 / 2505 in all; ``make_extract_fn`` equal to ``extract``;
   ms/frame of both in turns.

TF32 is switched off for matmuls and cuDNN (the plain versions must run
in full f32). The second line before the last is a JSON object with one
entry per kernel entry (``launches`` from the run of its path: phase 4
for the entries of the single-frame path, phase 6 for the window copy,
the chain front and the entries off every path, phase 13 (a) for the
bounded entries, phase 14 (c) for the one-octave entries of K1, K3 and
K4); the last line is the device record. ``--profile DIR`` also writes a torch.profiler table of
one run of the main path, of the window route and of the chain front to
DIR/profile*.txt and prints each run's counts, and phase 9's tables of
each timed SfM call. Phase 10 alone: ``drivers_phase(torch.device(
"cuda"))``; phase 11: ``sfm_cli_phase`` after ``build_phase()``; phase
12: ``parallel_phase(frames, dev, card)`` after ``build_phase()`` (run
from a file: its ranks are spawned processes that import ``__main__``);
phase 13 the same way with ``spatial_phase(frames, dev, card)``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FRAME_HW = (1080, 1920)
N_FRAMES = 4           # the batch of phases 3 and 5: make_frame seeds 0..3
BENCH_KEYPOINTS, BENCH_DESCRIPTORS = 2110, 2505
# kernel entries of each path (phase 4: single frame, phase 5: batch)
MAIN_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves", "compact",
             "refine_octaves", "orientation_hist_octaves",
             "descriptor_loop_octaves")
BATCH_PATH = MAIN_PATH
# the calibration probe
PROBE_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves", "compact")
# phase 6: the window route (single, batch), the chain front, and the
# entries that no extraction path calls
WINDOW_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves",
               "compact", "extract_windows", "orientation_hist_octaves",
               "descriptor_loop_octaves")
WINDOW_BATCH_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves",
                     "compact", "extract_windows_batched",
                     "orientation_hist_octaves", "descriptor_loop_octaves")
CHAIN_PATH = ("blur_chain", "blur_dog_thin", "extrema_mask_octaves",
              "compact", "refine_octaves", "orientation_hist_octaves",
              "descriptor_loop_octaves")
# the single-octave K3 and K4 entries run beneath the bucketed ones
OFF_PATH = ("descriptor_loop_patches", "orientation_hist_bucketed",
            "descriptor_loop_bucketed", "descriptor_loop", "orientation_hist",
            "extrema_mask", "extrema_mask_batched", "refine",
            "refine_batched")
# the launches over all octaves (and frames): exactly once on every
# extraction path (K2's on the fused routes, see FUSED_ONCE)
ONCE = ("extrema_mask_octaves", "compact", "orientation_hist_octaves",
        "descriptor_loop_octaves")
FUSED_ONCE = ONCE + ("refine_octaves",)
# which run's counts a kernel entry reports in the JSON line
LAUNCHES_FROM = {
    "blur_dog": "main", "blur_dog_thin": "main",
    "extrema_mask_octaves": "main", "compact": "main",
    "refine_octaves": "main",
    "orientation_hist_octaves": "main", "descriptor_loop_octaves": "main",
    "descriptor_loop": "per_octave", "extrema_mask": "per_octave",
    "extrema_mask_batched": "off_path", "orientation_hist": "per_octave",
    "refine": "off_path", "refine_batched": "off_path",
    "extract_windows": "windows", "extract_windows_batched": "windows_batch",
    "blur_chain": "chain", "descriptor_loop_patches": "off_path",
    "orientation_hist_bucketed": "off_path",
    "descriptor_loop_bucketed": "off_path",
    "refine_octaves_bounded": "sharded",
    "orientation_hist_octaves_bounded": "sharded",
    "descriptor_loop_octaves_bounded": "sharded"}
# the main path's host work, checked on one profiler pass of extract
MAX_LAUNCH_CALLS = 700
# NVIDIA's data sheet for the H100 SXM: device memory rate and the f32
# rate outside the tensor cores (every kernel here is plain f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
GOLDEN_TOL = dict(x=5e-3, y=5e-3, sigma=1e-3, ori=1e-3, desc=6e-3)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """The golden scenes' generator, tests/conftest.py::synthetic_image
    (that module imports jax, which this script must not)."""
    rng_ = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 40.0 + 20.0 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    for _ in range(12):
        cx, cy = rng_.uniform(0.15, 0.85) * w, rng_.uniform(0.15, 0.85) * h
        s = rng_.uniform(1.5, min(h, w) / 10.0)
        a = rng_.uniform(60, 160) * rng_.choice([-1.0, 1.0])
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img[h // 3:, : w // 4] += 50.0
    img[: h // 5, w // 2:] -= 40.0
    img += rng_.normal(0, 1.0, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def median_ms(fn, dev, reps: int = 20, warmup: int = 2) -> float:
    """Median wall time of ``fn()`` in ms: CUDA events on a CUDA device,
    the host clock on the CPU (for rehearsals only)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def closeness(got: torch.Tensor, ref: torch.Tensor) -> str:
    """How a result that passed its tolerance check agrees: "bit-equal
    to" or "within <max abs difference> of"."""
    if torch.equal(got, ref):
        return "bit-equal to"
    return f"within {float((got - ref).abs().max()):.3g} of"


def rel_row_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / (row max of |ref|) over rows with a non-zero
    reference, and max |got| over rows whose reference is all zero."""
    rowmax = ref.abs().amax(1, keepdim=True)
    err = (got - ref).abs()
    rel = torch.where(rowmax > 0, err / rowmax.clamp(min=1e-30), err)
    return float(rel.max()) if rel.numel() else 0.0


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


def card_phase(dev) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[dev.index or 0], flush=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(dev)} "
        f"(count {torch.cuda.device_count()})")
    return {"nvidia_smi": smi[dev.index or 0]}


def build_phase() -> None:
    from popsift_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    took = time.perf_counter() - t0
    say(f"build: {len(build.sources())} sources, nvcc "
        f"{'%.1f s' % build.build_seconds if build.build_seconds else 'cached'}"
        f", load {took:.1f} s")


def kernels_phase(frames: list, dev, reps: int = 20) -> list:
    """Each kernel and its plain version on the same tensors at the main
    path's shapes, all octaves of the first frame (the batched entries:
    all frames); returns the JSON rows."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import descriptors as D
    from popsift_tpu_torch.ops import extrema as E
    from popsift_tpu_torch.ops import orientation as O
    from popsift_tpu_torch.ops import patches as PT
    from popsift_tpu_torch.ops.kernels import (ENTRIES, blur_chain, blur_dog,
                                               compact, desc, extrema_mask,
                                               orient, refine, window)
    from popsift_tpu_torch.ops import pyramid as pyr_mod
    from popsift_tpu_torch.ops.pyramid import (build_pyramid,
                                               build_pyramid_frames)
    from popsift_tpu_torch.pipeline import build_extract_plan
    import torch.nn.functional as Fn

    frame = frames[0]
    cfg = SiftConfig(extrema_capacity=8192)
    plan = build_extract_plan(cfg, *frame.shape)
    blurs, dogs = build_pyramid(torch.from_numpy(frame).to(dev),
                                plan.pyramid)
    Z = cfg.total_levels - 3
    thr1 = float(np.float32(E._first_threshold(cfg)))
    maxlevel = cfg.total_levels - 1
    vlfeat = cfg.sift_mode == "vlfeat"
    caps, dims = plan.ext_caps, plan.pyramid.dims
    nO = len(caps)
    rows = []

    def row(name, err, ms, plain_ms, bound, library_ms=None,
            what=f"per frame (all {nO} octaves)"):
        mod, _, replaces = ENTRIES[name]
        rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        say(f"{name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library call {lib}, bound "
            f"{bound[0]:.4f} ms (by {bound[1]}) {what}")

    # The work each bound counts, from this run's shapes and rows. Bytes:
    # every input read once, every output written once. Operations:
    # nominal f32 counts of the function itself (no halo recomputation).
    px = [h * w for h, w in dims]             # pixels per octave
    spans = [(k.shape[0] - 1) // 2 for k in plan.pyramid.inc_kernels]
    levels = range(1, cfg.total_levels)
    # a blur level: two passes of 1 + 3S operations and the DoG's subtraction
    blur_ops = sum(p * (2 * (1 + 3 * spans[l]) + 1)
                   for p in px for l in levels)

    def conv_library(src, kernel):
        """Two F.conv2d passes on the replicate-padded plane and the
        subtraction: the library's form of one blur level and its DoG."""
        S = (kernel.shape[0] - 1) // 2
        w = torch.as_tensor(kernel, device=dev)
        x = src[:, None]
        h = Fn.conv2d(Fn.pad(x, (S, S, 0, 0), mode="replicate"),
                      w.view(1, 1, 1, -1))
        b = Fn.conv2d(Fn.pad(h, (0, 0, S, S), mode="replicate"),
                      w.view(1, 1, -1, 1))
        return b[:, 0], b[:, 0] - src

    # K5 blur + DoG: every (octave, level) of the frame, from the same
    # level l-1 as input
    # (src, filter, out, pick): the launch of level L - 3 also writes the
    # pick of every second pixel, the next octave's level 0, as in the pyramid
    bargs = [(blurs[o][l - 1:l], plan.pyramid.inc_kernels[l], None,
              torch.empty((1, *dims[o + 1]), device=dev)
              if l == cfg.total_levels - 3 and o + 1 < nO else None)
             for o in range(nO) for l in range(1, cfg.total_levels)]
    err = 0.0
    for src, k, _, pick in bargs:
        got = blur_dog.blur_dog(src, k, pick=pick)
        want = blur_dog.blur_dog_torch(src, k)
        sync(dev)
        err = max(err, float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        if pick is not None:
            check(bool(torch.equal(pick, blur_dog.pick_every_second(
                want[0], *pick.shape[-2:]))),
                f"K5 pick of {tuple(src.shape)} differs from the slice")
    check(err <= 1e-4, f"K5 blur/DoG differ by {err} (limit 1e-4)")
    n_pick = sum(a[3] is not None for a in bargs)
    say(f"K5 {'bit-equal to' if err == 0 else 'within 1e-4 of'} its plain "
        f"version over {len(bargs)} levels, its {n_pick} picks equal to "
        f"the slices")
    lerr = max(float((a - b).abs().max()) for src, k, _, _ in bargs
               for a, b in zip(conv_library(src, k),
                               blur_dog.blur_dog(src, k)))
    check(lerr <= 1e-3, f"F.conv2d blur/DoG differ from K5 by {lerr}")
    say(f"F.conv2d (two passes + subtraction) within {lerr:.3g} of K5")
    conv_ms = median_ms(lambda: [conv_library(*a[:2]) for a in bargs], dev,
                        reps)
    row(blur_dog.NAME, err,
        median_ms(lambda: [blur_dog.blur_dog(*a) for a in bargs], dev, reps),
        median_ms(lambda: [blur_dog.blur_dog_torch(*a) for a in bargs], dev,
                  reps),
        bound_ms(sum(12 * p for p in px for _ in levels)
                 + sum(4 * a[3].numel() for a in bargs if a[3] is not None),
                 blur_ops), conv_ms)

    # K5's thin entry: every level of the octaves from the first thin one on,
    # in one launch, on copies whose level 0 of the first octave is filled
    ft = pyr_mod.first_thin_octave(plan.pyramid)
    check(ft < nO, "no octave of the 1080p frame is thin")
    ks = list(plan.pyramid.inc_kernels[1:])
    src_lvl = cfg.total_levels - 3

    def thin_args():
        tb = [torch.zeros_like(blurs[o][None]) for o in range(ft, nO)]
        tb[0][0, 0] = blurs[ft][0]
        return tb, [torch.zeros_like(dogs[o][None]) for o in range(ft, nO)]

    tb, td = thin_args()
    blur_dog.blur_dog_thin(tb, td, ks, src_lvl)
    pb, pd = thin_args()
    blur_dog.blur_dog_thin_torch(pb, pd, ks, src_lvl)
    sync(dev)
    err = max(float((a - b).abs().max()) for a, b in zip(tb + td, pb + pd))
    check(err == 0, f"K5's thin entry differs from its plain version by {err}")
    check(all(torch.equal(tb[i][0], blurs[ft + i])
              and torch.equal(td[i][0], dogs[ft + i])
              for i in range(nO - ft)),
          "K5's thin entry differs from the pyramid's planes")
    say(f"K5's thin entry bit-equal to its plain version and to the "
        f"pyramid's planes on octaves {ft}..{nO - 1} "
        f"({[tuple(dims[o]) for o in range(ft, nO)]})")
    thin_px = px[ft:]
    n_lv = cfg.total_levels - 1
    row(blur_dog.NAME_THIN, err,
        median_ms(lambda: blur_dog.blur_dog_thin(tb, td, ks, src_lvl), dev,
                  reps),
        median_ms(lambda: blur_dog.blur_dog_thin_torch(pb, pd, ks, src_lvl),
                  dev, reps),
        bound_ms(4 * thin_px[0] + sum(8 * n_lv * p for p in thin_px)
                 + sum(4 * p for p in thin_px[1:]),
                 sum(p * (2 * (1 + 3 * spans[l]) + 1)
                     for p in thin_px for l in levels)),
        median_ms(lambda: [conv_library(blurs[o][l - 1:l], ks[l - 1])
                           for o in range(ft, nO)
                           for l in range(1, cfg.total_levels)], dev, reps),
        what=f"per frame (octaves {ft}..{nO - 1}, one launch)")
    del tb, td, pb, pd

    # K7 chain front: every octave's levels 1..L-1 from level 0 in groups
    # of three, the launch of level L-3 also writing the next octave's
    # level 0 (the pick), against the planes K5 wrote into the pyramid and
    # against its plain version, exactly
    G = pyr_mod.CHAIN_GROUP
    kern = list(plan.pyramid.inc_kernels[1:])
    pick_lvl = src_lvl - 1         # index of level L-3 among levels 1..L-1

    def chain_check(levels_, dogs_, tag):
        """K7 and its plain version on every octave of [N, L, H, W] level
        stacks: both equal to the stacks (K5's planes) and to the next
        octave's level 0, bit for bit. Returns the calls' arguments."""
        cargs = []
        for o in range(nO):
            pk = (torch.full_like(levels_[o + 1][:, 0], -1.0)
                  if o + 1 < nO else None)
            cargs.append((levels_[o][:, 0], kern, G, None, pk, pick_lvl))
            got = blur_chain.blur_chain(*cargs[-1])
            ppk = None if pk is None else torch.full_like(pk, -2.0)
            want = blur_chain.blur_chain_torch(levels_[o][:, 0], kern,
                                               pick=ppk, pick_level=pick_lvl)
            sync(dev)
            bad = [n for n, a, b in (
                ("levels", got[0], levels_[o][:, 1:]),
                ("DoGs", got[1], dogs_[o]),
                ("plain levels", want[0], got[0]),
                ("plain DoGs", want[1], got[1]),
                ("pick", pk, None if pk is None else levels_[o + 1][:, 0]),
                ("plain pick", ppk, pk)) if not (a is b or torch.equal(a, b))]
            check(not bad, f"K7 on octave {o} of {tag} differs from K5's "
                  f"planes or its plain version: {bad}")
        say(f"K7 bit-equal to K5's planes and to its plain version on all "
            f"{nO} octaves of {tag} (groups of {G}), its {nO - 1} picks "
            f"equal to the next octaves' level 0")
        return cargs

    cargs = chain_check([b[None] for b in blurs], [d[None] for d in dogs],
                        "frame 0")
    k7_dev = profile_counts(lambda: [blur_chain.blur_chain(*a)
                                     for a in cargs], dev)["ours_ms"]
    say(f"K7 over all {nO} octaves, device ms of one profiler pass: "
        f"{k7_dev}")
    n_groups = [min(G, len(kern) - g0) for g0 in range(0, len(kern), G)]
    row(blur_chain.NAME, 0.0,
        median_ms(lambda: [blur_chain.blur_chain(*a) for a in cargs], dev,
                  reps),
        median_ms(lambda: [blur_chain.blur_chain_torch(
            a[0], kern, pick=a[4], pick_level=pick_lvl) for a in cargs], dev,
            reps),
        bound_ms(sum((4 + 8 * n) * p for p in px for n in n_groups)
                 + sum(4 * a[4].numel() for a in cargs if a[4] is not None),
                 blur_ops), conv_ms)
    del cargs

    # K1 mask: Z + 2 f32 layers read, Z u8 layers written; 26 comparisons,
    # the contrast gate and their combination for each of Z layers' pixels
    def mask_bound(n_frames):
        return bound_ms(n_frames * sum(((Z + 2) * 4 + Z) * p for p in px),
                        n_frames * sum(30 * Z * p for p in px))

    dstk = [d[:Z + 2].contiguous() for d in dogs]
    err = 0
    for d in dstk:
        k = extrema_mask.candidate_mask(d, thr1)
        p = extrema_mask.candidate_mask_torch(d, thr1)
        sync(dev)
        err = max(err, int((k != p).sum()))
    check(err == 0, f"K1 mask differs from its plain version in {err} px")
    mask_plain_ms = median_ms(
        lambda: [extrema_mask.candidate_mask_torch(d, thr1) for d in dstk],
        dev, reps)
    row(extrema_mask.NAME, float(err),
        median_ms(lambda: [extrema_mask.candidate_mask(d, thr1)
                           for d in dstk], dev, reps),
        mask_plain_ms, mask_bound(1),
        what=f"per frame as {nO} single-octave launches")
    # one launch over all octaves, as the extraction path has it
    mk = extrema_mask.candidate_mask_octaves(dstk, thr1)
    sync(dev)
    err = sum(int((k[0] != extrema_mask.candidate_mask_torch(d, thr1)
                   .view(torch.bool)).sum()) for k, d in zip(mk, dstk))
    check(err == 0 and all(k.dtype == torch.bool for k in mk),
          f"K1 over all octaves differs from its plain version in {err} px")
    say(f"K1 over all {nO} octaves in one launch: bool masks, bit-equal to "
        f"the plain version")
    del mk
    row(extrema_mask.NAME_OCTAVES, float(err),
        median_ms(lambda: extrema_mask.candidate_mask_octaves(dstk, thr1),
                  dev, reps), mask_plain_ms, mask_bound(1))

    # K2 refine (bound: :func:`refine_bound`)
    cands = [E.collect_candidates(d, cfg, caps[o])
             for o, d in enumerate(dogs)]
    nf = [int(c.n_found) for c in cands]
    say(f"candidates per octave {nf}, dropped "
        f"{[int(c.n_dropped) for c in cands]}")
    args = [(dogs[o], c.x0, c.y0, c.z0, nf[o]) for o, c in enumerate(cands)]
    kw = dict(maxlevel=maxlevel, vlfeat=vlfeat)
    sk = torch.cat([refine.refine_state(*a, **kw) for a in args])
    sp = torch.cat([refine.refine_state_torch(*a, **kw) for a in args])
    err = float((sk - sp).abs().max())
    check(err <= 1e-5, f"K2 state differs by {err} (limit 1e-5)")
    w_row = torch.as_tensor(np.concatenate(
        [np.full(caps[o], dd[1]) for o, dd in enumerate(dims)]), device=dev)
    h_row = torch.as_tensor(np.concatenate(
        [np.full(caps[o], dd[0]) for o, dd in enumerate(dims)]), device=dev)
    cvalid = torch.cat([c.valid for c in cands])
    g = E.finalize_refined(sk, cvalid, cfg, w_row, h_row, 0, 0)
    gp = E.finalize_refined(sp, cvalid, cfg, w_row, h_row, 0, 0)
    check(bool(torch.equal(g.valid, gp.valid)),
          "K2 accept mask differs from its plain version")
    row(refine.NAME, err,
        median_ms(lambda: [refine.refine_state(*a, **kw) for a in args],
                  dev, reps),
        median_ms(lambda: [refine.refine_state_torch(*a, **kw)
                           for a in args], dev, reps),
        refine_bound(sum(nf), sum(caps)))

    # the compaction of all octaves' masks in one call: every mask byte
    # read once, the rows (three i32) and counts (two i64) written; one
    # compare a mask entry
    masks = E.candidate_masks(dogs, cfg)
    pin = cfg.compact_block_k

    def compact_bound(ms, caps_, F_):
        n = sum(m.numel() for m in ms)
        return bound_ms(n + F_ * (12 * sum(caps_) + 16 * len(caps_)), n)

    def compact_check(ms, caps_, F_, what):
        """The kernel against ``_compact_mask`` per frame and octave (its
        plain version), every output entry for entry."""
        got = compact.compact_octaves(ms, caps_, pin, F_)
        want = compact.compact_octaves_torch(ms, caps_, pin, F_)
        sync(dev)
        bad = [n for n, a, b in zip(("x0", "y0", "z0", "n_found",
                                     "n_dropped"), got, want)
               if not torch.equal(a, b)]
        check(not bad, f"compaction differs from _compact_mask on {what}: "
              f"{bad}")
        return got

    crow = compact_check(masks, caps, 1, f"the {nO} octaves of frame 0")
    check(crow[3][0].tolist() == nf, "compaction counts differ from the "
          "per-octave collections")
    sat_caps = build_extract_plan(cfg.replace(extrema_capacity=256),
                                  *frame.shape).ext_caps
    sat = compact_check(masks, sat_caps, 1, f"the plan of capacities "
                        f"{sat_caps}")
    check(bool((sat[3] == torch.tensor(sat_caps, device=dev)).any()),
          "the saturated plan saturated no octave")
    say(f"compaction entry for entry equal to _compact_mask on all {nO} "
        f"octaves of frame 0 (counts {nf}) and on the capacities "
        f"{list(sat_caps)} (counts {sat[3][0].tolist()}, dropped "
        f"{sat[4][0].tolist()}), padding rows included")
    c_dev = profile_counts(lambda: compact.compact_octaves(masks, caps, pin),
                           dev)["ours_ms"]
    say(f"compaction of frame 0, device ms of one profiler pass: {c_dev}")
    row(compact.NAME, 0.0,
        median_ms(lambda: compact.compact_octaves(masks, caps, pin), dev,
                  reps),
        median_ms(lambda: compact.compact_octaves_torch(masks, caps, pin),
                  dev, reps), compact_bound(masks, caps, 1))

    # K2 over all octaves in one launch, on the compaction's rows
    oargs_k2 = (list(dogs), *crow[:4], caps, 1)
    so = refine.refine_state_octaves(*oargs_k2, **kw)
    sp_o = refine.refine_state_octaves_torch(*oargs_k2, **kw)
    sync(dev)
    check(bool(torch.equal(so, sp_o)), "K2's launch over all octaves differs "
          "from its plain version")
    check(bool(torch.equal(so, sk)), "K2's launch over all octaves differs "
          "from its single-octave launches")
    say(f"K2 over all {nO} octaves in one launch: bit-equal to its plain "
        f"version and to the {nO} single-octave launches")
    row(refine.NAME_OCTAVES, 0.0,
        median_ms(lambda: refine.refine_state_octaves(*oargs_k2, **kw), dev,
                  reps),
        median_ms(lambda: refine.refine_state_octaves_torch(*oargs_k2, **kw),
                  dev, reps), refine_bound(sum(nf), sum(caps)))
    del masks, crow, sat, so, sp_o, oargs_k2

    # K6 window copy: the capacity-padded windows of every octave
    WR, WP = E.WINDOW_RADIUS, E.WINDOW_SIDE
    wargs = [(dogs[o], c.y0, c.x0, c.n_found, WR, WP, WP)
             for o, c in enumerate(cands)]
    wk = [window.extract_windows(*a) for a in wargs]
    wp = [window.extract_windows_torch(*a) for a in wargs]
    check(all(torch.equal(a, b) for a, b in zip(wk, wp)),
          "K6 windows differ from the plain version")
    check(all(bool((w[n:] == 0).all()) for w, n in zip(wk, nf)),
          "K6 rows past the count are not zero")
    say(f"K6 bit-equal to its plain version on {sum(nf)} live of "
        f"{sum(caps)} rows")
    del wk, wp

    def gather_library(vol, cy, cx, n_valid, radius, rows_, cols_):
        """One advanced-indexing gather: the library's form of K6 (no
        zeroing of the rows past the count)."""
        D_, H_, W_ = vol.shape
        yi = (cy[:, None] - radius + ar_p).clamp(0, H_ - 1)
        xi = (cx[:, None] - radius + ar_p).clamp(0, W_ - 1)
        return vol[torch.arange(D_, device=dev)[None, :, None, None],
                   yi[:, None, :, None], xi[:, None, None, :]]

    ar_p = torch.arange(WP, device=dev)
    wbytes = 4 * dogs[0].shape[0] * WP * WP

    def window_bound(n_live, n_rows):
        return bound_ms(n_live * wbytes + n_rows * (wbytes + 8), 0)

    row(window.NAME, 0.0,
        median_ms(lambda: [window.extract_windows(*a) for a in wargs], dev,
                  reps),
        median_ms(lambda: [window.extract_windows_torch(*a) for a in wargs],
                  dev, reps),
        window_bound(sum(nf), sum(caps)),
        median_ms(lambda: [gather_library(*a) for a in wargs], dev, reps))

    # K3 orientation histograms
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    R = O.max_ori_radius(cfg)
    oargs = []
    for o in range(nO):
        sl = slice(offs[o], offs[o + 1])
        oargs.append((blurs[o], g.x[sl], g.y[sl], g.sigma[sl], g.level[sl],
                      g.valid[sl], nf[o], R))
    hk = torch.cat([orient.orientation_hist(*a) for a in oargs])
    hp = torch.cat([orient.orientation_hist_torch(*a) for a in oargs])
    rel = rel_row_err(hk, hp)
    check(rel <= 1e-5, f"K3 histograms differ by {rel} x row max")
    k3_bound = ori_bound(g.sigma[g.valid], sum(caps))
    ori_ms = median_ms(lambda: [orient.orientation_hist(*a) for a in oargs],
                       dev, reps)
    ori_plain_ms = median_ms(lambda: [orient.orientation_hist_torch(*a)
                                      for a in oargs], dev, reps)
    row(orient.NAME, float((hk - hp).abs().max()), ori_ms, ori_plain_ms,
        k3_bound, what=f"per frame as {sum(n > 0 for n in nf)} single-octave "
                        f"launches")
    # one launch over the rows of all octaves, as the extraction path has it
    hargs_all = (list(blurs), [int(e) for e in offs[1:]], g.x, g.y, g.sigma,
                 g.level, g.valid, R)
    ho = orient.orientation_hist_octaves(*hargs_all)
    rel = rel_row_err(ho, hp)
    check(rel <= 1e-5, f"K3 over all octaves differs by {rel} x row max")
    check(bool(torch.equal(ho, hk)), "K3's launch over all octaves differs "
          "from its single-octave launches")
    check(bool(torch.equal(ho, orient.orientation_hist_octaves(*hargs_all))),
          "two runs of K3 differ")
    say(f"K3 over all {nO} octaves in one launch: within {rel:.3g} x row max "
        f"of its plain version, bit-equal to the single-octave launches and "
        f"to a second run")
    row(orient.NAME_OCTAVES, float((ho - hp).abs().max()),
        median_ms(lambda: orient.orientation_hist_octaves(*hargs_all), dev,
                  reps), ori_plain_ms, k3_bound)
    del ho

    # bucketed launches of K3: the same rows through two launches an octave
    split = cfg.sigma * 2.0 ** (2.5 / cfg.levels)
    r_small = int(round(3.0 * 1.5 * split))
    bo = [(a[0], a[1], a[2], a[3], a[4], a[5], R, split, r_small)
          for a in oargs]
    hb = torch.cat([orient.orientation_hist_bucketed(*a) for a in bo])
    rel = rel_row_err(hb, hk)
    check(rel <= 1e-5, f"bucketed K3 differs from the single launch by "
          f"{rel} x row max")
    say(f"bucketed K3 {closeness(hb, hk)} the single launch on the same "
        f"rows")
    hbp = torch.cat([orient.orientation_hist_bucketed(*a, plain=True)
                     for a in bo])
    row(orient.NAME_BUCKETED, float((hb - hbp).abs().max()),
        median_ms(lambda: [orient.orientation_hist_bucketed(*a) for a in bo],
                  dev, reps),
        median_ms(lambda: [orient.orientation_hist_bucketed(*a, plain=True)
                           for a in bo], dev, reps), k3_bound)

    # K4 descriptors
    oris = O.orientations_from_histograms(hk, g.valid)
    segs = tuple((int(offs[o]), caps[o], plan.job_caps[o])
                 for o in range(nO))
    jobs, counts = D.make_descriptor_jobs_segmented(
        g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid, segs)
    joff = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)
    counts = counts.tolist()
    radius = D.loop_patch_radius(cfg)
    dargs = []
    for o in range(nO):
        sl = slice(joff[o], joff[o + 1])
        dargs.append((blurs[o], jobs.x[sl], jobs.y[sl], jobs.sigma[sl],
                      jobs.level[sl], jobs.ang[sl], jobs.valid[sl],
                      counts[o], radius))
    say(f"descriptor jobs per octave {counts}")
    # one launch over the rows of all octaves, as the extraction path has it
    oargs_all = (list(blurs), [int(e) for e in joff[1:]], jobs.x, jobs.y,
                 jobs.sigma, jobs.level, jobs.ang, jobs.valid, radius)
    dk = desc.descriptor_loop_octaves(*oargs_all)
    dp = torch.cat([desc.descriptor_loop_torch(*a) for a in dargs])
    rel = rel_row_err(dk, dp)
    check(rel <= 1e-5, f"K4 descriptors differ by {rel} x row max")
    check(bool(torch.equal(dk, desc.descriptor_loop_octaves(*oargs_all))),
          "two runs of K4 differ")
    check(bool(torch.equal(dk, torch.cat([desc.descriptor_loop(*a)
                                          for a in dargs]))),
          "K4's launch over all octaves differs from its single-octave "
          "launches")
    say(f"K4 over all {nO} octaves in one launch: within {rel:.3g} x row "
        f"max of its plain version, bit-equal to the {nO} single-octave "
        f"launches and to a second run")
    n_jobs_cap = int(joff[-1])
    k4_bound = desc_bound(jobs.sigma[jobs.valid], radius, n_jobs_cap)
    plain_ms = median_ms(lambda: [desc.descriptor_loop_torch(*a)
                                  for a in dargs], dev, reps)
    row(desc.NAME_OCTAVES, float((dk - dp).abs().max()),
        median_ms(lambda: desc.descriptor_loop_octaves(*oargs_all), dev,
                  reps), plain_ms, k4_bound)
    row(desc.NAME, float((dk - dp).abs().max()),
        median_ms(lambda: [desc.descriptor_loop(*a) for a in dargs],
                  dev, reps), plain_ms, k4_bound,
        what=f"per frame as {sum(c > 0 for c in counts)} single-octave "
             f"launches")

    # bucketed launches of K4 on the same rows
    r_small = int(np.ceil(2.5 * 2.0 ** 0.5 * 3.0 * split)) + 2
    bd = [(a[0], a[1], a[2], a[3], a[4], a[5], a[6], radius, split, r_small)
          for a in dargs]
    db = torch.cat([desc.descriptor_loop_bucketed(*a) for a in bd])
    rel = rel_row_err(db, dk)
    check(rel <= 1e-5, f"bucketed K4 differs from the single launch by "
          f"{rel} x row max")
    say(f"bucketed K4 {closeness(db, dk)} the single launch on the same "
        f"rows")
    dbp = torch.cat([desc.descriptor_loop_bucketed(*a, plain=True)
                     for a in bd])
    rel = rel_row_err(db, dbp)
    check(rel <= 1e-5, f"bucketed K4 differs from its plain version by "
          f"{rel} x row max")
    row(desc.NAME_BUCKETED, float((db - dbp).abs().max()),
        median_ms(lambda: [desc.descriptor_loop_bucketed(*a) for a in bd],
                  dev, reps),
        median_ms(lambda: [desc.descriptor_loop_bucketed(*a, plain=True)
                           for a in bd], dev, reps), k4_bound)

    # the patch entry of K4 on the densest octave's real jobs: windows of
    # 104 x 128 cut around each job, as the JAX tests cut them
    od = int(np.argmax(counts))
    blur_o, jx, jy, jsig, jlev, jang, jval, jn, _ = dargs[od]
    prow = -(-(2 * radius + 1) // 8) * 8
    pcol = -(-(2 * radius + 1) // 128) * 128
    sel = slice(0, jn)
    pt, py0, px0 = PT.extract_patches_rect(
        PT.pad_for_patches(blur_o, max(prow, pcol)), jlev[sel],
        torch.round(jy[sel]).long(), torch.round(jx[sel]).long(), prow, pcol,
        radius, radius)
    pargs = (pt, py0, px0, jx[sel], jy[sel], jsig[sel], jang[sel], jval[sel],
             *dims[od])
    pk = desc.descriptor_loop_patches(*pargs)
    pp = desc.descriptor_loop_patches_torch(*pargs)
    rel = rel_row_err(pk, pp)
    check(rel <= 1e-5, f"patch entry differs from its plain version by "
          f"{rel} x row max")
    sargs = (blur_o, jx[sel], jy[sel], jsig[sel], jlev[sel], jang[sel],
             jval[sel], jn, radius)
    ks = desc.descriptor_loop(*sargs)
    # jobs whose support fits the static window: past it the stack entry
    # truncates and wraps as the XLA twin does, the patch entry pads zeros
    fits = torch.ceil(jsig[sel] * (3.0 * 2.5 * 2.0 ** 0.5)) + 2 <= radius
    rel = rel_row_err(pk[fits], ks[fits])
    check(rel <= 1e-5, f"patch entry differs from K4 by {rel} x row max")
    say(f"patch entry on octave {od}: {jn} jobs of {prow} x {pcol} cells, "
        f"within 1e-5 x row max of its plain version, "
        f"{closeness(pk[fits], ks[fits])} K4 on the {int(fits.sum())} jobs "
        f"whose support fits the window")
    k4_ms = median_ms(lambda: desc.descriptor_loop(*sargs), dev, reps)
    sup_o = (torch.ceil(jsig[sel][jval[sel]] * (3.0 * 2.5 * 2.0 ** 0.5)) + 2
             ).clamp(max=radius)
    row(desc.NAME_PATCHES, float((pk - pp).abs().max()),
        median_ms(lambda: desc.descriptor_loop_patches(*pargs), dev, reps),
        median_ms(lambda: desc.descriptor_loop_patches_torch(*pargs), dev,
                  max(3, reps // 4)),
        bound_ms(pt.numel() * 4 + jn * 128 * 4,
                 float(((2 * sup_o + 1) ** 2).sum()) * 90),
        what=f"on octave {od}'s {jn} jobs (K4 on the same jobs: "
             f"{k4_ms:.4f} ms)")
    del blurs, dogs, bargs, args, oargs, oargs_all, dargs, wargs, bo, bd
    del hargs_all, dstk
    del pt, pargs

    # batched K1 and K2 on all frames' stacks (frames back to back on the
    # layer axis), one launch per octave each
    F = len(frames)
    what = f"per batch of {F} frames (all {nO} octaves)"
    bblurs, bdogs = build_pyramid_frames(
        torch.from_numpy(np.stack(frames)).to(dev), plan.pyramid)
    # K7 on the four frames, one call an octave, against the batch's planes
    cargs = chain_check(bblurs, bdogs, f"the {F}-frame batch")
    k7_ms = median_ms(lambda: [blur_chain.blur_chain(*a) for a in cargs],
                      dev, reps)
    say(f"K7 on the {F}-frame batch: {k7_ms:.4f} ms a batch")
    del cargs, bblurs
    bdogs = [d.view(-1, *d.shape[2:]) for d in bdogs]
    err = 0
    for d in bdogs:
        k = extrema_mask.candidate_mask_batched(d, F, thr1)
        p = extrema_mask.candidate_mask_batched_torch(d, F, thr1)
        sync(dev)
        err = max(err, int((k != p).sum()))
    check(err == 0, f"batched K1 differs from its plain version in {err} px")
    row(extrema_mask.NAME_BATCHED, float(err),
        median_ms(lambda: [extrema_mask.candidate_mask_batched(d, F, thr1)
                           for d in bdogs], dev, reps),
        median_ms(lambda: [extrema_mask.candidate_mask_batched_torch(
            d, F, thr1) for d in bdogs], dev, reps), mask_bound(F),
        what=f"per batch of {F} frames as {nO} single-octave launches")
    mk = extrema_mask.candidate_mask_octaves(bdogs, thr1, F)
    sync(dev)
    check(all(torch.equal(k.view(torch.uint8),
                          extrema_mask.candidate_mask_batched_torch(d, F,
                                                                    thr1))
              for k, d in zip(mk, bdogs)),
          "K1 over all octaves of the batch differs from its plain version")
    del mk
    batch_ms = median_ms(
        lambda: extrema_mask.candidate_mask_octaves(bdogs, thr1, F), dev, reps)
    say(f"K1 over all {nO} octaves of {F} frames in one launch: bit-equal to "
        f"the plain version, {batch_ms:.4f} ms per batch (bound "
        f"{mask_bound(F)[0]:.4f} ms)")

    bc = [E.collect_candidates_batched(d, F, cfg, caps[o])
          for o, d in enumerate(bdogs)]
    say(f"batch candidates per octave and frame "
        f"{[c.n_found.tolist() for c in bc]}")
    bargs = [(bdogs[o], c.x0, c.y0, c.z0, c.n_found, F)
             for o, c in enumerate(bc)]
    sk = [refine.refine_state_batched(*a, **kw) for a in bargs]
    sp = [refine.refine_state_batched_torch(*a, **kw) for a in bargs]
    err = max(float((a - b).abs().max()) for a, b in zip(sk, sp))
    check(err == 0, f"batched K2 state differs by {err} (exact expected)")
    for o, c in enumerate(bc):
        w = dims[o][1]
        h = dims[o][0]
        va = E.finalize_refined(sk[o], c.valid.reshape(-1), cfg, w, h, 0, 0)
        vb = E.finalize_refined(sp[o], c.valid.reshape(-1), cfg, w, h, 0, 0)
        check(bool(torch.equal(va.valid, vb.valid)),
              f"batched K2 accept mask differs in octave {o}")
    row(refine.NAME_BATCHED, err,
        median_ms(lambda: [refine.refine_state_batched(*a, **kw)
                           for a in bargs], dev, reps),
        median_ms(lambda: [refine.refine_state_batched_torch(*a, **kw)
                           for a in bargs], dev, reps),
        refine_bound(sum(int(c.n_found.sum()) for c in bc), F * sum(caps)),
        what=what)

    # the compaction and K2's all-octave launch on the four frames
    bmasks = E.candidate_masks(bdogs, cfg, F)
    brow = compact_check(bmasks, caps, F, f"the {F}-frame batch")
    check(all(brow[3][:, o].tolist() == c.n_found.tolist()
              for o, c in enumerate(bc)),
          "batched compaction counts differ from the per-octave collections")
    bo_args = (bdogs, *brow[:4], caps, F)
    bc_live = brow[3].sum()
    sbo = refine.refine_state_octaves(*bo_args, **kw)
    check(bool(torch.equal(sbo, refine.refine_state_octaves_torch(
        *bo_args, **kw))), "K2's launch over all octaves of the batch differs "
          "from its plain version")
    boffs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    check(all(torch.equal(sbo.view(F, -1, 16)[:, boffs[o]:boffs[o + 1]],
                          sk[o].view(F, caps[o], 16)) for o in range(nO)),
          "K2's launch over all octaves of the batch differs from its "
          "batched launches")
    c_ms = median_ms(lambda: compact.compact_octaves(bmasks, caps, pin, F),
                     dev, reps)
    r_ms = median_ms(lambda: refine.refine_state_octaves(*bo_args, **kw),
                     dev, reps)
    say(f"compaction of the {F}-frame batch entry for entry equal to "
        f"_compact_mask, {c_ms:.4f} ms a batch (bound "
        f"{compact_bound(bmasks, caps, F)[0]:.4f} ms); K2 over all octaves "
        f"of the batch bit-equal to its plain version and to its batched "
        f"launches, {r_ms:.4f} ms a batch in one launch (bound "
        f"{refine_bound(int(bc_live), F * sum(caps))[0]:.4f} ms)")
    del bmasks, brow, bo_args, sbo

    # batched K6 on the same candidates
    wargs = [(bdogs[o], c.y0, c.x0, c.n_found, F, WR, WP, WP)
             for o, c in enumerate(bc)]
    for a in wargs:
        check(bool(torch.equal(window.extract_windows_batched(*a),
                               window.extract_windows_batched_torch(*a))),
              "batched K6 windows differ from the plain version")
    say("batched K6 bit-equal to its plain version")

    def gather_library_b(vol, cy, cx, n_found, F_, radius, rows_, cols_):
        D_ = vol.shape[0] // F_
        zi = (torch.arange(cy.shape[0], device=dev) // (cy.shape[0] // F_)
              * D_)[:, None] + torch.arange(D_, device=dev)
        yi = (cy[:, None] - radius + ar_p).clamp(0, vol.shape[1] - 1)
        xi = (cx[:, None] - radius + ar_p).clamp(0, vol.shape[2] - 1)
        return vol[zi[:, :, None, None], yi[:, None, :, None],
                   xi[:, None, None, :]]

    row(window.NAME_BATCHED, 0.0,
        median_ms(lambda: [window.extract_windows_batched(*a)
                           for a in wargs], dev, reps),
        median_ms(lambda: [window.extract_windows_batched_torch(*a)
                           for a in wargs], dev, reps),
        window_bound(sum(int(c.n_found.sum()) for c in bc), F * sum(caps)),
        median_ms(lambda: [gather_library_b(*a) for a in wargs], dev, reps),
        what=what)
    return rows


def golden_cases() -> dict:
    """name -> (image, SiftConfig, the oracle's descriptor variant) of the
    five goldens of tests/golden (scripts/make_golden.py:28-55)."""
    from popsift_tpu_torch.config import SiftConfig
    s64 = synthetic_image(64, 80, seed=3)
    return {"scene64_default": (s64, SiftConfig(octaves=3), "loop"),
            "scene120_default": (synthetic_image(120, 160, seed=7),
                                 SiftConfig(octaves=4), "loop"),
            "scene64_vlfeat_igrid": (s64, SiftConfig(
                octaves=3, sift_mode="vlfeat", desc_mode="igrid",
                norm_mode="classic"), "igrid"),
            "scene64_grid_fixed9": (s64, SiftConfig(
                octaves=3, gauss_mode="fixed9", desc_mode="grid"), "grid"),
            "scene64_iloop_interp": (s64, SiftConfig(
                octaves=3, desc_mode="iloop",
                downscale_mode="interpolate"), "iloop")}


def golden_phase(dev) -> None:
    """The port on the card against the five oracle goldens of
    tests/golden (configurations of scripts/make_golden.py:28-55,
    tolerances of tests/test_golden.py:21-24)."""
    from popsift_tpu_torch.api import PopSift
    for name, (img, cfg, _) in golden_cases().items():
        want = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
        host = PopSift(cfg, device=dev).enqueue(img).get()
        feats = sorted(host.features(), key=lambda f: (
            round(f.x, 4), round(f.y, 4), round(f.sigma, 4)))
        got = dict(
            x=np.array([f.x for f in feats], np.float32),
            y=np.array([f.y for f in feats], np.float32),
            sigma=np.array([f.sigma for f in feats], np.float32),
            num_ori=np.array([f.num_ori for f in feats], np.int32),
            ori=np.concatenate([f.orientations[:f.num_ori] for f in feats]),
            desc=np.concatenate([f.descriptors for f in feats]))
        check(len(got["x"]) == len(want["x"]),
              f"{name}: {len(got['x'])} keypoints vs golden "
              f"{len(want['x'])}")
        check(np.array_equal(got["num_ori"], want["num_ori"]),
              f"{name}: orientation counts differ from the golden")
        errs = {k: float(np.max(np.abs(got[k] - want[k])))
                for k in GOLDEN_TOL}
        for k, tol in GOLDEN_TOL.items():
            check(errs[k] < tol, f"{name}: {k} off the golden by {errs[k]}")
        say(f"golden {name}: {len(got['x'])} keypoints, "
            f"{len(got['desc'])} descriptors, max errors {errs}")


def profile_counts(fn, dev, table: str | None = None) -> dict:
    """One torch.profiler pass of ``fn()`` (which ends in a synchronize):
    device ops, device busy time, host launch calls, stream syncs, sort
    calls and the device time of the port's own kernels; with ``table``
    also the profiler's tables written to that file."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    avg = prof.key_averages()
    if table:
        with open(table, "w") as fh:
            for key in ("self_cuda_time_total", "cpu_time_total"):
                fh.write(avg.table(sort_by=key, row_limit=40))
                fh.write("\n")
    dev_ops = [e for e in avg if e.device_type == DeviceType.CUDA]
    ours = {}       # the port's kernels live in anonymous namespaces
    for e in dev_ops:
        m = re.search(r"\(anonymous namespace\)::(\w+_kernel)", e.key)
        if m and "at::" not in e.key:
            ours[m.group(1)] = round(ours.get(m.group(1), 0.0)
                                     + e.self_device_time_total / 1e3, 4)
    count = lambda pred: sum(e.count for e in avg if pred(e.key))
    return {"device_ops": sum(e.count for e in dev_ops),
            "device_busy_ms": round(sum(e.self_device_time_total
                                        for e in dev_ops) / 1e3, 4),
            "launch_calls": count(lambda k: "LaunchKernel" in k),
            "stream_syncs": count(lambda k: "StreamSynchronize" in k),
            "sorts": count(lambda k: k == "aten::sort"),
            "copies": count(lambda k: k == "aten::copy_"),
            "nonzero": count(lambda k: k == "aten::nonzero"),
            "ours_ms": ours}


def no_sync_check(tag: str, fn, want, dev) -> dict:
    """Run ``fn()`` on frames already on the card (once to warm up: the
    first run on a plan makes its constant tensors), then again with
    every launch counter reset just before it, under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising call
    raises), hold its result to
    ``want`` in every field and check that the compaction and K2's
    all-octave launch ran once and K2's one-octave entries not at all;
    then one profiler pass of it. Returns the pass's counts."""
    from popsift_tpu_torch.ops import kernels
    fn()               # the first run on a plan makes the plan's constants
    sync(dev)
    kernels.reset_launch_counts()
    on_card = dev.type == "cuda"       # a CPU rehearsal has no sync mode
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    launches = kernels.launch_counts()
    sync(dev)
    for name in FUSED_ONCE:
        check(launches[name] == 1, f"{tag}: {name} launched "
              f"{launches[name]} times")
    for name in ("refine", "refine_batched"):
        check(launches[name] == 0, f"{tag}: {name} launched")
    for name, a, b in zip(got._fields, got, want):
        check(a.shape == b.shape and bool(torch.equal(a, b)),
              f"{tag}: {name} differs from the enqueued run")
    counts = profile_counts(fn, dev)
    say(f"{tag}: completed under sync debug mode \"error\", equal to the "
        f"enqueued run in every field; one profiler pass: {counts}")
    check(counts["stream_syncs"] == 0, f"{tag}: stream syncs")
    check(counts["launch_calls"] < MAX_LAUNCH_CALLS,
          f"{tag}: {counts['launch_calls']} host launch calls (limit "
          f"{MAX_LAUNCH_CALLS})")
    check(counts["sorts"] == 0, f"{tag}: a sort ran")
    return counts


def main_path_phase(frame: np.ndarray, dev, reps: int = 5) -> dict:
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.pipeline import build_extract_plan, extract

    cfg = SiftConfig(extrema_capacity=8192)
    ps = PopSift(cfg, device=dev)
    kernels.reset_launch_counts()
    job = ps.enqueue(frame)
    host = job.get()
    launches = kernels.launch_counts()
    raw = job.raw
    say(f"main path: {host.getFeatureCount()} keypoints, "
        f"{host.getDescriptorCount()} descriptors, launches {launches}")
    for name in MAIN_PATH:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    for name in FUSED_ONCE:
        check(launches[name] == 1,
              f"{name} launched {launches[name]} times on the main path")
    for name in ("descriptor_loop", "extrema_mask", "orientation_hist",
                 "refine", "refine_batched"):
        check(launches[name] == 0, f"single-octave {name} ran on the main "
              f"path {launches[name]} times")
    dropped = raw.octave_dropped.tolist()
    check(all(d == 0 for d in dropped), f"dropped candidates {dropped}")
    check(host.getFeatureCount() == BENCH_KEYPOINTS
          and host.getDescriptorCount() == BENCH_DESCRIPTORS,
          f"bench frame gave {host.getFeatureCount()} / "
          f"{host.getDescriptorCount()}, expected {BENCH_KEYPOINTS} / "
          f"{BENCH_DESCRIPTORS}")
    for k in ("x", "y", "sigma", "orientations", "descriptors"):
        check(bool(np.isfinite(getattr(host, k)).all()), f"non-finite {k}")
    check(host.descriptors.shape == (BENCH_DESCRIPTORS, 128),
          f"descriptor shape {host.descriptors.shape}")

    plan = build_extract_plan(cfg, *frame.shape)
    uploaded = torch.from_numpy(frame).to(dev)
    no_sync_check("extract of an uploaded frame",
                  lambda: extract(uploaded, plan, dev), raw, dev)

    def run(plain):
        f = extract(frame, plan, dev, plain=plain)
        sync(dev)
        return f

    # warm, interleaved: kernel, plain, plain, kernel, ...
    run(False)
    run(True)
    tk, tp = [], []
    for i in range(reps):
        for plain in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            run(plain)
            (tp if plain else tk).append((time.perf_counter() - t0) * 1e3)
    ms_k, ms_p = statistics.median(tk), statistics.median(tp)
    say(f"main path ms/frame (warm median of {reps}, host clock, ends in "
        f"synchronize): kernels {ms_k:.2f} ({1e3 / ms_k:.2f} frames/s), "
        f"plain torch {ms_p:.2f}")
    dflt = PopSift(SiftConfig(), device=dev).enqueue(frame).get()
    say(f"SiftConfig() default: {dflt.getFeatureCount()} keypoints, "
        f"{dflt.getDescriptorCount()} descriptors")
    return launches


def _same_field(name: str, a: torch.Tensor, b: torch.Tensor) -> str:
    """Check one field of a batched frame against its single-frame run:
    integer and bool fields exact, float fields bit-equal or within
    1e-6 x the field's magnitude. Returns "equal" or the difference."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"batched {name}: {a.dtype}{list(a.shape)} vs "
          f"{b.dtype}{list(b.shape)}")
    if torch.equal(a, b):
        return "equal"
    check(a.is_floating_point(), f"batched {name} differs from enqueue")
    diff = float((a - b).abs().max())
    mag = float(b.abs().max())
    check(diff <= 1e-6 * mag, f"batched {name} differs by {diff} "
          f"(magnitude {mag})")
    return f"{diff:.3g}"


def batch_phase(frames: list, dev, reps: int = 3) -> dict:
    """The batch path of ``frames`` against single-frame ``enqueue``,
    then calibration; returns the batch run's launch counts."""
    import warnings

    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops.pyramid import first_thin_octave
    from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                            extract_batch)

    cfg = SiftConfig(extrema_capacity=8192)
    plan = build_extract_plan(cfg, *frames[0].shape)
    n_oct, F = len(plan.ext_caps), len(frames)
    ps = PopSift(cfg, device=dev)
    kernels.reset_launch_counts()
    jobs = ps.enqueue_batch(frames)
    hosts = [j.get() for j in jobs]
    launches = kernels.launch_counts()
    say(f"batch of {F}: {[h.getFeatureCount() for h in hosts]} keypoints, "
        f"{[h.getDescriptorCount() for h in hosts]} descriptors, "
        f"launches {launches}")
    for name in BATCH_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              f"batch path")
    n_wide = first_thin_octave(plan.pyramid)
    check(launches["blur_dog"] == n_wide * (cfg.total_levels - 1)
          and launches["blur_dog_thin"] == 1,
          f"K5 launched {launches['blur_dog']} times for {n_wide} wide "
          f"octaves and {launches['blur_dog_thin']} times for the "
          f"{n_oct - n_wide} thin ones")
    for name in FUSED_ONCE:
        check(launches[name] == 1,
              f"{name} launched {launches[name]} times for the batch")
    for name in ("extrema_mask", "extrema_mask_batched", "refine",
                 "refine_batched", "orientation_hist", "descriptor_loop"):
        check(launches[name] == 0, f"{name} ran in the batch")

    for f, (frame, job, host) in enumerate(zip(frames, jobs, hosts)):
        one = ps.enqueue(frame)
        single = one.get()
        check(host.getFeatureCount() == single.getFeatureCount()
              and host.getDescriptorCount() == single.getDescriptorCount(),
              f"frame {f}: batch {host.getFeatureCount()} / "
              f"{host.getDescriptorCount()} vs enqueue "
              f"{single.getFeatureCount()} / {single.getDescriptorCount()}")
        res = {k: _same_field(k, a, b) for k, a, b in
               zip(job.raw._fields, job.raw, one.raw)}
        say(f"frame {f}: {host.getFeatureCount()} / "
            f"{host.getDescriptorCount()}, batch vs enqueue {res}")
    check(hosts[0].getFeatureCount() == BENCH_KEYPOINTS
          and hosts[0].getDescriptorCount() == BENCH_DESCRIPTORS
          and not jobs[0].raw.octave_dropped.any(),
          "frame 0 of the batch is not 2110 / 2505 with nothing dropped")

    imgs = np.stack(frames)
    uploaded = torch.from_numpy(imgs).to(dev)
    no_sync_check(f"extract_batch of {F} uploaded frames",
                  lambda: extract_batch(uploaded, plan, dev),
                  extract_batch(imgs, plan, dev), dev)

    def run(route):
        if route == "batch":
            out = extract_batch(imgs, plan, dev)
        elif route == "plain batch":
            out = extract_batch(imgs, plan, dev, plain=True)
        else:
            out = [extract(im, plan, dev) for im in frames]
        sync(dev)
        return out

    routes = ("batch", "single", "plain batch")
    for r in routes:
        run(r)
    times = {r: [] for r in routes}
    for i in range(reps):
        for r in (routes if i % 2 == 0 else routes[::-1]):
            t0 = time.perf_counter()
            run(r)
            times[r].append((time.perf_counter() - t0) * 1e3 / F)
    ms = {r: statistics.median(t) for r, t in times.items()}
    say(f"ms/frame over {F} frames (warm median of {reps}, host clock, "
        f"ends in synchronize): batch {ms['batch']:.2f}, single-frame "
        f"enqueue {ms['single']:.2f}, plain batch {ms['plain batch']:.2f}")

    # the calibration probe is detect-only: K5 and the dense K1 entry
    ps2 = PopSift(SiftConfig(), device=dev)
    kernels.reset_launch_counts()
    cal = ps2.calibrate(frames[:1])
    probe_launches = kernels.launch_counts()
    say(f"calibrate probe launches {probe_launches}")
    for name, n in probe_launches.items():
        check((n > 0) == (name in PROBE_PATH),
              f"calibration probe launched {name} {n} times")
    check(probe_launches["extrema_mask_octaves"] == 1
          and probe_launches["compact"] == 1,
          "the probe of one frame launched K1 or the compaction more than "
          "once")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        job = ps2.enqueue(frames[0])
        host = job.get()
    cand = job.raw.octave_candidates.tolist()
    check(all(c < cap for c, cap in zip(cand, cal.ext_caps)),
          f"calibrated capacities {cal.ext_caps} saturated by {cand}")
    check(not [w for w in caught if "saturated" in str(w.message)],
          "saturation warning after calibrate")
    say(f"calibrate: capacities {list(cal.ext_caps)}, candidates {cand}, "
        f"dropped {job.raw.octave_dropped.tolist()}, "
        f"{host.getFeatureCount()} keypoints, "
        f"{host.getDescriptorCount()} descriptors")
    return launches


def routes_phase(frames: list, dev, reps: int = 7) -> dict:
    """The window detection route and the chain front at full width
    against the default route (``detect="fused"``, ``front="level"``),
    then the entries that no extraction path calls; returns the launch
    counts of each run."""
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import descriptors as D
    from popsift_tpu_torch.ops import extrema as E
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops import orientation as O
    from popsift_tpu_torch.ops import patches as PT
    from popsift_tpu_torch.ops.kernels import (desc, extrema_mask, orient,
                                               refine)
    from popsift_tpu_torch.ops.pyramid import (CHAIN_GROUP, build_pyramid,
                                               first_thin_octave)
    from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                            extract_batch)

    cfg = SiftConfig(extrema_capacity=8192)
    plan = build_extract_plan(cfg, *frames[0].shape)
    n_oct, F = len(plan.ext_caps), len(frames)
    n_groups = -(-(cfg.total_levels - 1) // CHAIN_GROUP)
    base = PopSift(cfg, device=dev)
    base_jobs = [base.enqueue(f) for f in frames]
    out = {}

    def drive(tag, path, batch, **route):
        """One run of a route with the counters reset just before it."""
        ps = PopSift(cfg, device=dev, **route)
        kernels.reset_launch_counts()
        jobs = ps.enqueue_batch(frames) if batch else [ps.enqueue(frames[0])]
        hosts = [j.get() for j in jobs]
        launches = kernels.launch_counts()
        out[tag] = launches
        say(f"{tag} {route}: {[h.getFeatureCount() for h in hosts]} "
            f"keypoints, {[h.getDescriptorCount() for h in hosts]} "
            f"descriptors, launches {launches}")
        for name in path:
            check(launches[name] > 0, f"{tag}: kernel {name} was not launched")
        for name, n in launches.items():
            check(n == 0 or name in path, f"{tag}: {name} launched {n} times")
        for name in (FUSED_ONCE if "refine_octaves" in path else ONCE):
            check(launches[name] == 1,
                  f"{tag}: {name} launched {launches[name]} times")
        check(hosts[0].getFeatureCount() == BENCH_KEYPOINTS
              and hosts[0].getDescriptorCount() == BENCH_DESCRIPTORS
              and not jobs[0].raw.octave_dropped.any(),
              f"{tag}: frame 0 is not 2110 / 2505 with nothing dropped")
        for f, job in enumerate(jobs):
            res = {k: _same_field(k, a, b) for k, a, b in
                   zip(job.raw._fields, job.raw, base_jobs[f].raw)}
            check(bool(np.isfinite(hosts[f].descriptors).all()),
                  f"{tag}: non-finite descriptors in frame {f}")
            say(f"{tag} frame {f} vs the default route: {res}")
        return launches

    n = drive("windows", WINDOW_PATH, False, detect="windows")
    check(n["extract_windows"] == n_oct and n["refine_octaves"] == 0,
          f"window route launched K6 {n['extract_windows']} times for "
          f"{n_oct} octaves and K2 {n['refine_octaves']} times")
    n = drive("windows_batch", WINDOW_BATCH_PATH, True, detect="windows")
    check(n["extract_windows_batched"] == n_oct
          and n["refine_octaves"] == 0,
          f"batched window route launched K6 "
          f"{n['extract_windows_batched']} times for {n_oct} octaves")
    n = drive("chain", CHAIN_PATH, False, front="chain")
    n_wide = first_thin_octave(plan.pyramid)
    check(n["blur_chain"] == n_wide * n_groups and n["blur_dog"] == 0
          and n["blur_dog_thin"] == 1,
          f"chain front launched K7 {n['blur_chain']} times for {n_wide} "
          f"wide octaves of {n_groups} groups, K5 {n['blur_dog']} times and "
          f"its thin entry {n['blur_dog_thin']} times")
    drive("chain_batch", CHAIN_PATH, True, front="chain")
    drive("windows_chain", CHAIN_PATH[:2] + WINDOW_PATH[2:], False,
          detect="windows", front="chain")

    # the entries off every path, driven once on the densest octave's rows
    # of frame 0 (finite, the expected shape; phase 3 held them against
    # their plain versions)
    raw = base_jobs[0].raw
    od = int(raw.octave_candidates.argmax())
    offs = np.concatenate([[0], np.cumsum(plan.ext_caps)]).astype(int)
    sl = slice(offs[od], offs[od + 1])
    blurs, dogs = build_pyramid(torch.from_numpy(frames[0]).to(dev),
                                plan.pyramid)
    scale = 2.0 ** (od - cfg.upscale_factor)
    kx, ky, ks = (raw.x[sl] / scale, raw.y[sl] / scale, raw.sigma[sl] / scale)
    level = torch.round(torch.log2(ks.clamp(min=1e-6) / cfg.sigma)
                        * cfg.levels).long()
    valid = raw.valid[sl] & (raw.num_ori[sl] > 0)   # the octave's keypoints
    split = cfg.sigma * 2.0 ** (2.5 / cfg.levels)
    radius = D.loop_patch_radius(cfg)
    kernels.reset_launch_counts()
    hist = orient.orientation_hist_bucketed(
        blurs[od], kx, ky, ks, level, valid, O.max_ori_radius(cfg), split,
        int(round(4.5 * split)))
    ang = raw.ori[sl][:, 0]
    dsc = desc.descriptor_loop_bucketed(
        blurs[od], kx, ky, ks, level, ang, valid, radius, split,
        int(np.ceil(2.5 * 2.0 ** 0.5 * 3.0 * split)) + 2)
    rows = valid.nonzero().squeeze(1)
    prow = -(-(2 * radius + 1) // 8) * 8
    pcol = -(-(2 * radius + 1) // 128) * 128
    pt, py0, px0 = PT.extract_patches_rect(
        PT.pad_for_patches(blurs[od], max(prow, pcol)), level[rows],
        torch.round(ky[rows]).long(), torch.round(kx[rows]).long(), prow,
        pcol, radius, radius)
    dpt = desc.descriptor_loop_patches(pt, py0, px0, kx[rows], ky[rows],
                                       ks[rows], ang[rows], valid[rows],
                                       *plan.pyramid.dims[od])
    # K2's one-octave and batched entries on the densest octave, against
    # the rows of that octave in K2's all-octave launch of the main path
    cap = plan.ext_caps[od]
    cand = E.collect_candidates(dogs[od], cfg, cap)
    kw = dict(maxlevel=cfg.total_levels - 1,
              vlfeat=cfg.sift_mode == "vlfeat")
    one = refine.refine_state(dogs[od], cand.x0, cand.y0, cand.z0,
                              int(cand.n_found), **kw)
    pair = E.collect_refined_batched(torch.cat([dogs[od], dogs[od]]), 2, cfg,
                                     cap)
    rows_o = E.compact_octaves(E.candidate_masks(dogs, cfg), cfg,
                               plan.ext_caps)
    full = E.refine_octaves(dogs, rows_o, cfg, plan.ext_caps)
    check(bool(torch.equal(one, full[sl]))
          and bool(torch.equal(pair.vals[:cap], one))
          and bool(torch.equal(pair.vals[cap:], one)),
          "off-path entries: K2's one-octave or batched entry differs from "
          "its all-octave launch")
    thr1 = float(np.float32(E._first_threshold(cfg)))
    m1 = extrema_mask.candidate_mask(dogs[od], thr1)
    m2 = extrema_mask.candidate_mask_batched(
        torch.cat([dogs[od], dogs[od]]), 2, thr1)
    check(bool(m1.any()) and bool(torch.equal(m2[0], m1))
          and bool(torch.equal(m2[1], m1)),
          "off-path entries: K1's single-octave and batched entries differ")
    out["off_path"] = kernels.launch_counts()
    say(f"entries off every path on octave {od} ({rows.numel()} keypoints): "
        f"launches {out['off_path']}")
    for name in OFF_PATH:
        check(out["off_path"][name] > 0, f"{name} was not launched")
    check(hist.shape == (valid.numel(), 36)
          and dsc.shape == (valid.numel(), 128)
          and dpt.shape == (rows.numel(), 128), "off-path entries: shapes")
    for t in (hist, dsc, dpt):
        check(bool(torch.isfinite(t).all()), "off-path entries: non-finite")
    check(bool((hist[valid].sum(1) > 0).all() and (dpt.sum(1) > 0).all()
               and (dsc[valid].sum(1) > 0).all()),
          "off-path entries: an empty row for a valid keypoint")
    rel = rel_row_err(dpt, dsc[rows])
    say(f"patch entry against bucketed K4 on these keypoints: "
        f"{rel:.3g} x row max")

    # warm ms/frame, interleaved with the default route
    imgs = np.stack(frames)
    routes = {"default": {}, "windows": dict(detect="windows"),
              "chain": dict(front="chain"),
              "windows+chain": dict(detect="windows", front="chain")}

    def run(route, batch):
        if batch:
            extract_batch(imgs, plan, dev, **routes[route])
        else:
            extract(frames[0], plan, dev, **routes[route])
        sync(dev)

    for batch, nrep in ((False, reps), (True, max(3, reps - 2))):
        names = list(routes)
        for r in names:
            run(r, batch)
        times = {r: [] for r in names}
        for i in range(nrep):
            order = names[i % len(names):] + names[:i % len(names)]
            for r in order:
                t0 = time.perf_counter()
                run(r, batch)
                times[r].append((time.perf_counter() - t0) * 1e3
                                / (F if batch else 1))
        say(f"{'batch of %d' % F if batch else 'single frame'} ms/frame "
            f"(warm median of {nrep}, min in brackets, interleaved, host "
            f"clock, ends in synchronize): " + ", ".join(
                f"{r} {statistics.median(t):.2f} [{min(t):.2f}]"
                for r, t in times.items()))

    # the chain front against the level front: one profiler pass each of
    # frames already on the card, in turns, single frame and the batch
    # (launch calls, device busy, the port's kernels' device time)
    up = {False: torch.from_numpy(frames[0]).to(dev),
          True: torch.from_numpy(imgs).to(dev)}
    go = {False: extract, True: extract_batch}
    prof = {}
    for batch in (False, True):
        for r in ("default", "chain", "chain", "default"):
            key = f"{r} {'batch' if batch else 'single'}"
            prof.setdefault(key, []).append(profile_counts(
                lambda: go[batch](up[batch], plan, dev, **routes[r]), dev))
    for key, runs in prof.items():
        say(f"{key} front profile (two passes in turns): launch calls "
            f"{[c['launch_calls'] for c in runs]}, device ops "
            f"{[c['device_ops'] for c in runs]}, device busy ms "
            f"{[c['device_busy_ms'] for c in runs]}, stream syncs "
            f"{[c['stream_syncs'] for c in runs]}, the port's kernels (ms) "
            f"{runs[0]['ours_ms']}")
    # K3 and K4 latency bound? Their device time for the frame's jobs
    # against the batch's four times as many, on the default route
    for k in ("orientation_hist_kernel", "descriptor_loop_kernel"):
        one = [c["ours_ms"].get(k, 0.0) for c in prof["default single"]]
        four = [c["ours_ms"].get(k, 0.0) for c in prof["default batch"]]
        grow = statistics.mean(four) / max(statistics.mean(one), 1e-9)
        say(f"{k}: device ms {one} for frame 0's jobs, {four} for the "
            f"{F} frames' (x {grow:.2f} for x {F} the work)")
    return out


def _same_ransac(tag: str, got, ref, err_fn, x1, x2, valid,
                 thresh: float) -> None:
    """A RANSAC result on the card against the CPU run from the same
    ranks: the model within 1e-4 after scale and sign are normalised, or
    a different hypothesis whose MSAC score lies within 1e-6 relative;
    the inlier masks equal except points whose error under the CPU model
    lies within 1e-4 relative of the gate. The score is printed: it is
    the chosen 8-point hypothesis's, whose f32 null vector differs
    between the two SVD solvers by about its condition number x eps."""
    a = ref.model.flatten() / ref.model.norm()
    b = got.model.cpu().flatten() / got.model.norm().cpu()
    b = b if float(a @ b) >= 0 else -b
    model_err = float((a - b).abs().max())
    s_ref, s_got = float(ref.score), float(got.score)
    check(model_err <= 1e-4 or abs(s_got - s_ref) <= 1e-6 * abs(s_ref),
          f"{tag}: model off the CPU run by {model_err} (scores {s_got} / "
          f"{s_ref})")
    err = err_fn(ref.model[None], x1, x2)[0]
    near = (err - thresh).abs() <= 1e-4 * thresh
    differ = got.inliers.cpu() != ref.inliers
    check(not bool((differ & ~near & valid).any()),
          f"{tag}: inlier masks differ away from the gate")
    say(f"{tag}: card against CPU from the same ranks: model {model_err:.3g}"
        f" after normalisation, score {s_got:.6g} / {s_ref:.6g}, inliers "
        f"{int(got.n_inliers)} / {int(ref.n_inliers)}, "
        f"{int(differ.sum())} mask entries differ at the gate")


def _synthetic_pairs(seed: int, n_edges: int, n: int = 1000):
    """Seeded two-view scenes: normalized observations of points in a wide
    field of view from cameras 15 degrees and a unit baseline apart,
    3e-4 noise, a fifth of each edge's rows outliers, the last rows of
    each edge invalid. Returns (x1, x2, valid) as f32/bool [B, N, .]."""
    rng = np.random.default_rng(seed)
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    a = np.deg2rad(15.0)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    x1s, x2s, vs = [], [], []
    for e in range(n_edges):
        X = rng.uniform([-3, -3, 2], [3, 3, 5], size=(n, 3))
        Xc = X @ R.T + np.array([1.0, 0.2 * e, 0.3])
        x1 = X[:, :2] / X[:, 2:3] + rng.normal(0, 3e-4, (n, 2))
        x2 = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 3e-4, (n, 2))
        x2[: n // 5] = rng.uniform(-1, 1, (n // 5, 2))
        valid = np.arange(n) < n - 10 * (e + 1)
        x1s.append(x1)
        x2s.append(x2)
        vs.append(valid)
    return (torch.from_numpy(np.stack(x1s).astype(np.float32)),
            torch.from_numpy(np.stack(x2s).astype(np.float32)),
            torch.from_numpy(np.stack(vs)))


def match_phase(frames: list, dev, per_frame: dict, reps: int = 10,
                shift: tuple = (3, 5)) -> dict:
    """popsift-match on the card: two ``enqueue``s in matching mode with
    the launch counters reset just before them, the matchers against
    their CPU runs, RANSAC, the CLI, and the times of each (CUDA events,
    median of ``reps``). ``per_frame`` holds the main path's launches of
    one frame (phase 4). Returns the times."""
    import contextlib
    import io
    import tempfile

    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.cli import match as match_cli
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.io.image import write_pgm
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops import matching as M
    from popsift_tpu_torch.sfm import twoview as T

    f0, f1 = frames[0], frames[1]
    fs = np.roll(f0, shift, axis=(0, 1))
    ps = PopSift(SiftConfig(extrema_capacity=8192), mode="matching",
                 device=dev)
    kernels.reset_launch_counts()
    d0 = ps.enqueue(f0).get()
    ds = ps.enqueue(fs).get()
    launches = kernels.launch_counts()
    say(f"match path: two enqueues, launches {launches}")
    for name, n in launches.items():
        want = 2 * per_frame[name] if name in MAIN_PATH else 0
        check(n == want, f"match path: {name} launched {n} times, expected "
              f"{want} (twice the main path's {per_frame.get(name, 0)})")
    for name in FUSED_ONCE:
        check(launches[name] == 2, f"match path: {name} not once per image")
    check(d0.getFeatureCount() == BENCH_KEYPOINTS
          and d0.getDescriptorCount() == BENCH_DESCRIPTORS,
          f"match path: frame 0 gave {d0.getFeatureCount()} / "
          f"{d0.getDescriptorCount()}")
    d1 = ps.enqueue(f1).get()
    say(f"match path: descriptors frame 0 {d0.getDescriptorCount()}, "
        f"shifted {ds.getDescriptorCount()}, seed 1 "
        f"{d1.getDescriptorCount()} of {d0.descriptors.shape[0]} padded rows")

    v0 = d0.desc_valid
    n_valid = int(v0.sum())
    own = d0.match(d0)
    live = v0.nonzero().squeeze(1)
    best = own.best_idx[live]
    # a row whose descriptor another row repeats bit for bit matches the
    # lower of the two rows (the first minimal column, as JAX's argmin)
    other = best != live
    twins = bool(torch.equal(d0.descriptors[best[other]],
                             d0.descriptors[live[other]]))
    check(twins and bool((best[other] < live[other]).all())
          and float(own.best_dist[live].max()) < 1e-6,
          "self-match: a valid row's best is neither itself nor an earlier "
          "row with the same descriptor, or lies at distance >= 1e-6")
    say(f"self-match of frame 0: {n_valid - int(other.sum())} of {n_valid} "
        f"valid rows match themselves, {int(other.sum())} an earlier row "
        f"with a bit-identical descriptor; distances "
        f"{float(own.best_dist[live].min()):.3g} to "
        f"{float(own.best_dist[live].max()):.3g}")

    exact = {}
    for tag, dr in (("shifted", ds), ("seed 1", d1)):
        got = exact[tag] = d0.match(dr)
        live = v0.nonzero().squeeze(1)
        ref = M.match_descriptors(d0.descriptors[live].cpu(), v0[live].cpu(),
                                  dr.descriptors.cpu(), dr.desc_valid.cpu())
        g = [f[live].cpu() for f in got]
        for k in (2, 3):
            check(bool(torch.isclose(g[k], ref[k], rtol=0, atol=1e-4).all()),
                  f"frame 0 / {tag}: distances off the CPU run by more than "
                  f"1e-4")
        ties = ((g[0] != ref.best_idx) | (g[1] != ref.second_idx)
                | (g[4] != ref.accept))
        n_ties = int(ties.sum())
        check(n_ties <= 1e-3 * n_valid, f"frame 0 / {tag}: {n_ties} rows "
              f"differ from the CPU run (near-ties), over 0.1 % of {n_valid}")
        say(f"frame 0 / {tag}: {int(g[4].sum())} accepted; indices and "
            f"accept equal to the CPU run on {n_valid - n_ties} of {n_valid} "
            f"valid rows ({n_ties} near-ties), distances within 1e-4")

    ex = exact["shifted"]
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        tf32 = d0.match(ds)
        restored = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = False
    check(restored and all(torch.equal(a, b) for a, b in zip(tf32, ex)),
          "the matcher's result changed with TF32 on, or the switch was "
          "not restored")
    say("matcher with TF32 on: equal to the run with it off in every field")

    args = (d0.descriptors, v0, ds.descriptors, ds.desc_valid)
    q8 = M.match_descriptors_q8(*args)
    ref = M.match_descriptors_q8(d0.descriptors[live].cpu(), v0[live].cpu(),
                                 ds.descriptors.cpu(), ds.desc_valid.cpu())
    check(all(torch.equal(a[live].cpu(), b) for a, b in zip(q8, ref)),
          "q8 matcher: the card differs from the CPU run")
    for name, r in (("q8", q8), ("pruned", M.match_descriptors_pruned(*args))):
        same = (r.best_idx == ex.best_idx)[ex.accept]
        recall = float((same & r.accept[ex.accept]).float().mean())
        nearest = float(same.float().mean())
        # the q8 ratio test flips accepts whose exact ratio lies near 0.8
        # (a tenth of frame 0 / shifted's accepted rows lie above 0.68)
        check(nearest >= 0.99 and (name == "q8" or recall >= 0.99),
              f"{name} matcher: nearest neighbour kept on {nearest}, recall "
              f"{recall} against exact")
        say(f"{name} matcher on frame 0 / shifted: the exact matcher's "
            f"nearest neighbour kept on {nearest:.4f} of its accepted rows, "
            f"recall (same neighbour and accepted) {recall:.4f}"
            + (", equal to its CPU run in every field" if name == "q8"
               else ""))

    # RANSAC: a homography on frame 0 / shifted's accepted matches
    acc = ex.accept.nonzero().squeeze(1)
    lk, rk = d0.raw.desc_kp[acc], ds.raw.desc_kp[ex.best_idx[acc]]
    n_acc = acc.numel()
    cap = max(64, 1 << (n_acc - 1).bit_length())
    pl = torch.zeros(cap, 2, device=dev)
    pr = torch.zeros(cap, 2, device=dev)
    pl[:n_acc] = torch.stack([d0.raw.x[lk], d0.raw.y[lk]], 1)
    pr[:n_acc] = torch.stack([ds.raw.x[rk], ds.raw.y[rk]], 1)
    vmask = torch.arange(cap, device=dev) < n_acc
    gen = torch.Generator(device=dev).manual_seed(0)
    hom = T.ransac_homography(gen, pl, pr, vmask, thresh=4.0, n_hyp=512)
    H = hom.model.double().cpu()
    h, w = f0.shape
    corners = torch.tensor([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                            [w - 1, h - 1, 1]], dtype=torch.float64)
    mapped = corners @ H.T
    true = torch.tensor([shift[1], shift[0]], dtype=torch.float64)
    moved = mapped[:, :2] / mapped[:, 2:] - corners[:, :2]
    corner_err = float((moved - true).abs().max())
    # the ratio test accepts wrong matches too (a quarter of this pair's
    # lie tens of px off): hold the inliers to the matches that the known
    # shift moves within the 2 px gate, and their least-squares shift
    # (the mean displacement) to 0.05 px; a 4-point hypothesis carries
    # its points' noise (0.08 px median) to the corners
    disp = (pr - pl)[:n_acc].double().cpu()
    off = (disp - true).norm(dim=1)
    inl = hom.inliers[:n_acc].cpu()
    ls_err = float((disp[inl].mean(0) - true).abs().max())
    n_inl, n_true = int(hom.n_inliers), int((off < 2.0).sum())
    n_wrong = int((inl & (off >= 2.5)).sum())
    check(n_inl >= 0.9 * n_true and n_wrong == 0,
          f"homography: {n_inl} inliers against {n_true} matches within 2 "
          f"px of the shift, {n_wrong} inliers 2.5 px or more off it")
    check(ls_err <= 0.05 and corner_err <= 0.5,
          f"homography: the inliers' mean shift {ls_err} px and the model's "
          f"corners {corner_err} px off the ({shift[1]}, {shift[0]}) shift")
    say(f"homography RANSAC on frame 0 / shifted: {n_inl} inliers of {n_acc}"
        f" accepted matches ({n_true} lie within 2 px of the known shift); "
        f"the inliers' mean shift within {ls_err:.4f} px, the model's "
        f"corners within {corner_err:.4f} px of ({shift[1]}, {shift[0]})")

    # RANSAC from the same ranks on the card and on the CPU
    x1, x2, vv = _synthetic_pairs(0, 3)
    ranks = T.draw_ranks(torch.Generator().manual_seed(1), vv, 512, 8)
    thresh = 1e-5
    ref = T.ransac_essential(None, x1[0], x2[0], vv[0], thresh, ranks=ranks[0])
    got = T.ransac_essential(None, x1[0].to(dev), x2[0].to(dev),
                             vv[0].to(dev), thresh, ranks=ranks[0].to(dev))
    _same_ransac("essential RANSAC", got, ref, T.sampson_error, x1[0], x2[0],
                 vv[0], thresh)
    ref = T.solve_pairs_batch(None, x1, x2, vv, thresh, ranks=ranks)
    got = [a.cpu() for a in T.solve_pairs_batch(
        None, x1.to(dev), x2.to(dev), vv.to(dev), thresh,
        ranks=ranks.to(dev))]
    good = ref[2]
    x_err = ((got[3] - ref[3]).abs().amax(-1) / ref[3].norm(dim=-1))[good]
    errs = {"R": float((got[0] - ref[0]).abs().max()),
            "t": float((got[1] - ref[1]).abs().max()),
            "X (relative, good rows)": float(x_err.max())}
    check(errs["R"] <= 1e-4 and errs["t"] <= 1e-4 and errs[
        "X (relative, good rows)"] <= 1e-4 and torch.equal(got[2], good),
        f"solve_pairs_batch: card against CPU {errs}, good rows equal "
        f"{torch.equal(got[2], good)}")
    say(f"solve_pairs_batch of 3 edges: card against CPU from the same ranks"
        f" {errs}, good rows equal ({int(good.sum())})")

    # the CLI (no capacity flag: SiftConfig()) on frame 0 / shifted written
    # as PGM, against the API run with the same configuration
    dflt = PopSift(SiftConfig(), mode="matching", device=dev)
    e0, es = dflt.enqueue(f0).get(), dflt.enqueue(fs).get()
    api_acc = int(e0.match(es).accept.sum())
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("f0.pgm", "shifted.pgm")]
        write_pgm(paths[0], f0)
        write_pgm(paths[1], fs)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = match_cli.main(["-l", paths[0], "-r", paths[1], "--device",
                                 str(dev), "--geom", "homography"])
    lines = out.getvalue().splitlines()
    cli_acc = int([l for l in lines if l.startswith("accepted matches:")][0]
                  .split(": ")[1])
    geom = [l for l in lines if l.startswith("geometric verification")]
    check(rc == 0 and cli_acc == api_acc and len(geom) == 1,
          f"CLI: rc {rc}, {cli_acc} accepted against the API's {api_acc}")
    say(f"CLI --device {dev} --geom homography: {cli_acc} accepted matches "
        f"(the API run of SiftConfig(): {api_acc}); {geom[0]}")

    # times
    L = d0.descriptors.shape[0]
    t = {}
    t["match_descriptors"] = median_ms(lambda: d0.match(ds), dev, reps, 1)

    def library():
        for a in range(0, L, 4096):
            torch.topk(torch.cdist(d0.descriptors[a:a + 4096],
                                   ds.descriptors), 2, 1, largest=False)

    t["library"] = median_ms(library, dev, reps, 1)
    t["match_descriptors_q8"] = median_ms(
        lambda: M.match_descriptors_q8(*args), dev, reps, 1)
    t["match_descriptors_pruned"] = median_ms(
        lambda: M.match_descriptors_pruned(*args), dev, reps, 1)
    L_d = e0.descriptors.shape[0]
    t["match_descriptors_default"] = median_ms(lambda: e0.match(es), dev,
                                               reps, 1)
    t["ransac_homography"] = median_ms(lambda: T.ransac_homography(
        gen, pl, pr, vmask, thresh=4.0, n_hyp=512), dev, reps, 1)
    xd, x2d, vd = x1.to(dev), x2.to(dev), vv.to(dev)
    t["ransac_essential"] = median_ms(lambda: T.ransac_essential(
        gen, xd[0], x2d[0], vd[0], thresh, n_hyp=512), dev, reps, 1)
    t["solve_pairs_batch"] = median_ms(lambda: T.solve_pairs_batch(
        gen, xd, x2d, vd, thresh, n_hyp=512), dev, reps, 1)
    for n_rows, key in ((L, "match_descriptors"),
                        (L_d, "match_descriptors_default")):
        ops_ms = 2.0 * n_rows * n_rows * 128 / F32_FLOP_PER_S * 1e3
        field_ms = 4.0 * n_rows * n_rows / HBM_BYTES_PER_S * 1e3
        t[key + "_bound"] = max(ops_ms, field_ms)
        say(f"exact matcher {n_rows} x {n_rows}: {t[key]:.3f} ms, bound "
            f"{max(ops_ms, field_ms):.3f} ms (operations {ops_ms:.3f}, the "
            f"distance field's bytes {field_ms:.3f})")
    say(f"matcher library call (cdist + topk(2), 4096 rows a call) "
        f"{L} x {L}: {t['library']:.3f} ms")
    say("phase 7 times, ms, CUDA events, median of %d: %s"
        % (reps, json.dumps({k: round(v, 4) for k, v in t.items()})))
    return t


# phase 8: the extraction variants on the bench frame, each a set of
# SiftConfig keywords beside extrema_capacity=8192
VARIANTS = {
    "vlfeat_igrid": dict(sift_mode="vlfeat", desc_mode="igrid",
                         norm_mode="classic"),
    "grid_fixed9": dict(gauss_mode="fixed9", desc_mode="grid"),
    "iloop_interp": dict(desc_mode="iloop", downscale_mode="interpolate"),
    "sift_opencv": dict(sift_mode="opencv"),
    "direct": dict(scaling_mode="direct"),
    "relative_all": dict(gauss_mode="vlfeat-relative-all"),
    "fixed15": dict(gauss_mode="fixed15"),
    "upscale0": dict(upscale_factor=0.0),
    "filter_largest": dict(filter_max_extrema=1000, filter_grid_size=2,
                           grid_filter_mode="largest"),
    "filter_smallest": dict(filter_max_extrema=1000, filter_grid_size=2,
                            grid_filter_mode="smallest"),
    "filter_random": dict(filter_max_extrema=1000, filter_grid_size=2,
                          grid_filter_mode="random"),
}
# driven through enqueue_batch of the four frames on the window route
# (loop descriptors: a plain-torch variant costs 0.25-1 s a frame)
BATCH_VARIANT = ("interp_relative_all_filter_windows_batch",
                 dict(downscale_mode="interpolate",
                      gauss_mode="vlfeat-relative-all",
                      filter_max_extrema=1000))
# held against the port's CPU run on a 480 x 640 crop of the bench frame
CPU_VARIANT = dict(sift_mode="opencv", gauss_mode="fixed15",
                   downscale_mode="interpolate", filter_max_extrema=300)
INT_FIELDS = ("octave", "num_ori", "valid", "ori_valid", "desc_kp",
              "desc_valid", "n_keypoints", "n_descriptors",
              "octave_candidates", "octave_dropped")


def expected_launches(cfg, plan, detect: str, batch: bool) -> dict:
    """Launches per kernel entry of one extraction of ``cfg``: K5 once
    per level of every octave it blurs (octave 0 of the fixed modes is
    plain torch) and its thin entry once where the strategy allows it
    (incremental, pick every second pixel, indirect scaling), K1, the
    compaction and K3 once, K2 once on the fused route or K6 once per
    octave on the window route, K4 once for ``desc_mode="loop"`` (the
    other variants are plain torch), nothing else."""
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops.pyramid import first_thin_octave
    n_oct = len(plan.pyramid.dims)
    first = first_thin_octave(plan.pyramid)
    fixed = cfg.gauss_mode in ("fixed9", "fixed15")
    want = dict.fromkeys(kernels.ENTRIES, 0)
    want.update({"blur_dog": (cfg.total_levels - 1)
                 * (first - (1 if fixed else 0)),
                 "blur_dog_thin": int(first < n_oct),
                 "extrema_mask_octaves": 1, "compact": 1,
                 "orientation_hist_octaves": 1,
                 "descriptor_loop_octaves": int(cfg.desc_mode == "loop")})
    if detect == "windows":
        want["extract_windows_batched" if batch else "extract_windows"] = \
            n_oct
    else:
        want["refine_octaves"] = 1
    return want


def _same_features(tag: str, got, ref, desc_mode: str,
                   tol: dict | None = None) -> dict:
    """``got`` against ``ref`` (SiftFeatures of the same frames): masks,
    counts and the other integer fields exact, then x, y, sigma,
    orientations and descriptors within ``tol`` (default: the kernels'
    run against the plain run on the card, x, y and sigma bit-equal, K2
    and K5 being bit-equal to their plain versions, orientations and
    descriptors within the golden tolerances, since K3's summation order
    moves an angle in its last bits and the descriptor with it; a
    plain-torch descriptor variant's rows whose angles are bit-equal
    must be bit-equal). Returns the largest differences."""
    for name in INT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        check(a.shape == b.shape and bool(torch.equal(a, b)),
              f"{tag}: {name} differs from the reference run")
    valid, dvalid, ov = ref.valid, ref.desc_valid, ref.ori_valid
    diff = lambda a, b, m: float((a - b)[m].abs().max()) if bool(m.any()) \
        else 0.0
    err = {k: diff(getattr(got, k), getattr(ref, k), valid)
           for k in ("x", "y", "sigma")}
    err["ori"] = diff(got.ori, ref.ori, ov)
    err["desc"] = diff(got.desc, ref.desc, dvalid)
    if tol is None:
        tol = dict(x=0.0, y=0.0, sigma=0.0, ori=GOLDEN_TOL["ori"],
                   desc=GOLDEN_TOL["desc"])
        if desc_mode != "loop":
            same = (got.ori == ref.ori).all(-1).gather(-1, got.desc_kp) \
                & dvalid
            err["rows_with_moved_angle"] = int((dvalid & ~same).sum())
            check(bool(torch.equal(got.desc[same], ref.desc[same])),
                  f"{tag}: descriptor rows with bit-equal angles differ")
    for k, t in tol.items():
        check(err[k] <= t if t == 0.0 else err[k] < t,
              f"{tag}: {k} differs by {err[k]} (limit {t})")
    return err


def _held_kernels(run, cfg) -> dict:
    """Run ``run()`` with K3's and (for ``desc_mode="loop"``) K4's calls
    of the pipeline held to their plain versions on the same inputs
    (rows within 1e-5 x the row's max); returns the largest relative
    differences."""
    import popsift_tpu_torch.pipeline as P
    real_o = P._ori.orientation_histograms_octaves
    real_d = P._desc.compute_descriptors_octaves
    rel = {"K3": 0.0, "K4": 0.0}

    def ori(blurs, ext, cfg_, row_ends, F=1, plain=False):
        k = real_o(blurs, ext, cfg_, row_ends, F, plain)
        rel["K3"] = max(rel["K3"], rel_row_err(
            k, real_o(blurs, ext, cfg_, row_ends, F, True)))
        return k

    def desc(blurs, jobs, row_ends, cfg_, plain=False):
        k = real_d(blurs, jobs, row_ends, cfg_, plain)
        if cfg_.desc_mode == "loop":
            rel["K4"] = max(rel["K4"], rel_row_err(
                k, real_d(blurs, jobs, row_ends, cfg_, True)))
        return k

    P._ori.orientation_histograms_octaves = ori
    P._desc.compute_descriptors_octaves = desc
    try:
        run()
    finally:
        P._ori.orientation_histograms_octaves = real_o
        P._desc.compute_descriptors_octaves = real_d
    for name, r in rel.items():
        check(r <= 1e-5, f"{name} rows differ from the plain version by "
              f"{r} x row max")
    return rel


def variants_phase(frames: list, dev, reps: int = 5) -> dict:
    """The extraction variants at 1080p: each configuration of
    ``VARIANTS`` through ``PopSift.enqueue`` of frame 0 (and
    ``BATCH_VARIANT`` through ``enqueue_batch`` of the four frames on the
    window route) with every counter reset just before it, held to the
    expected launches (:func:`expected_launches`), to the same
    configuration with ``plain=True`` on the card (:func:`_same_features`)
    and run again under ``torch.cuda.set_sync_debug_mode("error")``
    (equal in every field); warm ms/frame, median of ``reps``, beside the
    default configuration's. Then ``CPU_VARIANT`` on a 480 x 640 crop
    against the port's CPU run, the plain-torch descriptor variants timed
    on the bench frame's jobs beside K4, K1 on a textured frame and
    batches of 2 and 8 frames. Returns the times."""
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import descriptors as D
    from popsift_tpu_torch.ops import extrema as E
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops.pyramid import build_pyramid_frames
    from popsift_tpu_torch.pipeline import build_extract_plan, extract_batch

    out = {}

    def drive(tag, kw, batch=False, detect="fused"):
        cfg = SiftConfig(extrema_capacity=8192, **kw)
        fr = frames if batch else frames[:1]
        plan = build_extract_plan(cfg, *fr[0].shape)
        ps = PopSift(cfg, device=dev, detect=detect)
        kernels.reset_launch_counts()
        jobs = ps.enqueue_batch(fr) if batch else [ps.enqueue(fr[0])]
        hosts = [j.get() for j in jobs]
        launches = kernels.launch_counts()
        want = expected_launches(cfg, plan, detect, batch)
        check(launches == want, f"{tag}: launches {launches}, expected "
              f"{want}")
        uploaded = torch.from_numpy(np.stack(fr)).to(dev)

        def run(plain=False):
            return extract_batch(uploaded, plan, dev, plain=plain,
                                 detect=detect)

        got = run()
        for f, job in enumerate(jobs):
            for name, a, b in zip(job.raw._fields, job.raw, got):
                check(bool(torch.equal(a, b[f])), f"{tag}: frame {f}'s "
                      f"{name} differs between enqueue and extract_batch")
        err = _same_features(tag, got, run(plain=True), cfg.desc_mode)
        err.update(_held_kernels(run, cfg))
        sync(dev)
        if dev.type == "cuda":      # a CPU rehearsal has no sync mode
            torch.cuda.set_sync_debug_mode("error")
        try:
            again = run()
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        for name, a, b in zip(got._fields, again, got):
            check(bool(torch.equal(a, b)), f"{tag}: {name} of the run under "
                  f"sync debug mode differs")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3 / len(fr))
        ms = statistics.median(times)
        for h in hosts:
            for k in ("x", "y", "sigma", "descriptors"):
                check(bool(np.isfinite(getattr(h, k)).all()),
                      f"{tag}: non-finite {k}")
        out[tag] = ms
        say(f"variant {tag} {kw}{' batch of %d' % len(fr) if batch else ''}"
            f"{' detect=' + detect if detect != 'fused' else ''}: "
            f"{[h.getFeatureCount() for h in hosts]} keypoints, "
            f"{[h.getDescriptorCount() for h in hosts]} descriptors, "
            f"candidates {jobs[0].raw.octave_candidates.tolist()}, "
            f"launches as expected "
            f"{ {k: v for k, v in launches.items() if v} }, 0 syncs, "
            f"against plain {err}, {ms:.2f} ms/frame (warm median of "
            f"{reps})")
        return plan

    drive("default", {})
    for tag, kw in VARIANTS.items():
        drive(tag, kw)
    drive(BATCH_VARIANT[0], BATCH_VARIANT[1], batch=True, detect="windows")

    # one variant on a 480 x 640 crop: the card against the port's CPU run
    h, w = frames[0].shape
    y0, x0 = max(0, (h - 480) // 2), max(0, (w - 640) // 2)
    crop = np.ascontiguousarray(frames[0][y0:y0 + 480, x0:x0 + 640])
    cfg = SiftConfig(extrema_capacity=1024, **CPU_VARIANT)
    cplan = build_extract_plan(cfg, *crop.shape)
    on_card = extract_batch(crop[None], cplan, dev)
    on_cpu = extract_batch(crop[None], cplan, torch.device("cpu"))
    err = _same_features("480 x 640 crop, card against CPU",
                         type(on_cpu)(*(a.cpu() for a in on_card)), on_cpu,
                         cfg.desc_mode, tol=dict(GOLDEN_TOL))
    say(f"variant {CPU_VARIANT} on a {crop.shape[0]} x {crop.shape[1]} "
        f"crop at ({y0}, {x0}): "
        f"{int(on_cpu.n_keypoints[0])} keypoints, "
        f"{int(on_cpu.n_descriptors[0])} descriptors on the card and on the "
        f"CPU, masks and counts exact, largest differences {err}")

    # the plain-torch descriptor variants on the bench frame's jobs, beside
    # K4 on the same jobs (CUDA events)
    plan = build_extract_plan(SiftConfig(extrema_capacity=8192),
                              *frames[0].shape)
    grab = {}
    real = D.compute_descriptors_octaves

    def capture(blurs, jobs, row_ends, cfg_, plain=False):
        grab.update(blurs=blurs, jobs=jobs, row_ends=row_ends)
        return real(blurs, jobs, row_ends, cfg_, plain)

    D.compute_descriptors_octaves = capture
    try:
        extract_batch(frames[0][None], plan, dev)
    finally:
        D.compute_descriptors_octaves = real
    jobs, ends = grab["jobs"], grab["row_ends"]
    n_valid = int(jobs.valid.sum())
    base = SiftConfig(extrema_capacity=8192)
    k4 = median_ms(lambda: real(grab["blurs"], jobs, ends, base), dev, reps)
    # each valid job's support (as K4's bound counts it) read once, 128
    # bins written a row; about 90 operations a sample, as K4's pixel
    sup = (torch.ceil(jobs.sigma[jobs.valid] * (3.0 * 2.5 * 2.0 ** 0.5))
           + 2).clamp(max=D.loop_patch_radius(base))
    support_bytes = float(((2 * sup + 3) ** 2).sum()) * 4
    rows_bytes = int(jobs.valid.numel()) * 128 * 4
    table = {"loop (K4)": (k4, None)}
    for mode, samples in (("igrid", 40 * 40), ("grid", 16 * 16 * 16),
                          ("iloop", 16 * 32 * 32)):
        cfg_m = base.replace(desc_mode=mode)
        ms = median_ms(lambda: D.descriptor_variant(grab["blurs"], jobs, ends,
                                                    cfg_m), dev, 3, 1)
        table[mode] = (ms, bound_ms(support_bytes + rows_bytes,
                                    n_valid * samples * 90.0))
        out[f"desc_{mode}"] = ms
    say(f"descriptor variants on the bench frame's {int(jobs.x.shape[0])} "
        f"job rows ({n_valid} valid), ms (CUDA events, median of {reps} "
        f"for K4, of 3 for the variants) "
        f"and bound: " + ", ".join(
            f"{m} {t:.3f}" + (f" (bound {b[0]:.4f} by {b[1]}, "
                              f"{t / k4:.1f} x K4)" if b else "")
            for m, (t, b) in table.items()))

    # K1 on a textured 1080p frame against the bench frame
    k1 = {}
    cfg = SiftConfig(extrema_capacity=8192)
    for name, img in (("bench frame", frames[0]),
                      ("synthetic_image(%d, %d)" % (h, w),
                       synthetic_image(h, w))):
        _, dogs = build_pyramid_frames(torch.from_numpy(img[None]).to(dev),
                                       plan.pyramid)
        dogs = [d.view(-1, *d.shape[2:]) for d in dogs]
        masks = E.candidate_masks(dogs, cfg)
        k1[name] = (median_ms(lambda: E.candidate_masks(dogs, cfg), dev,
                              reps * 4),
                    int(sum(int(m.sum()) for m in masks)))
    say("K1 over all octaves, ms (CUDA events) and candidates: "
        + ", ".join(f"{n} {t:.4f} ({c})" for n, (t, c) in k1.items()))
    out.update({f"k1 {n}": t for n, (t, _) in k1.items()})

    # batch sizes other than four
    import bench
    many = [bench.make_frame(h, w, seed=s) for s in range(8)]
    for F in (1, 2, 8):
        up = torch.from_numpy(np.stack(many[:F])).to(dev)
        res = extract_batch(up, plan, dev)
        check(int(res.n_keypoints[0]) == BENCH_KEYPOINTS
              and int(res.n_descriptors[0]) == BENCH_DESCRIPTORS,
              f"batch of {F}: frame 0 gave {int(res.n_keypoints[0])} / "
              f"{int(res.n_descriptors[0])}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            extract_batch(up, plan, dev)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3 / F)
        out[f"batch {F}"] = statistics.median(times)
    say("extract_batch ms/frame by batch size (warm median of 3, host "
        "clock, ends in synchronize): " + ", ".join(
            f"F={F} {out[f'batch {F}']:.2f}" for F in (1, 2, 8)))
    say("phase 8 ms/frame (warm median of %d): %s" % (reps, json.dumps(
        {k: round(v, 3) for k, v in out.items()})))
    return out


# ---------------------------------------------------------------------------
# phase 9: the SfM geometry (sfm/ba.py, sfm/pnp.py) at the size of the
# repo's BA benchmark problem (scripts/bench_sfm_kernels.py:73-75)
# ---------------------------------------------------------------------------

BA_CAMS, BA_POINTS, BA_VIEWS = 100, 40_000, 5
BA_INTR = (500.0, 500.0, 320.0, 240.0)     # f = 500 on 640 x 480
# ransac_pnp_batch as IncrementalSfM calls it: pnp_chunk images
# (incremental.py:124), rows padded to a power of two (:424-433), its gate
# (:122)
PNP_B, PNP_ROWS, PNP_VALID, PNP_THRESH = 16, 2048, 1500, 2e-4


def _rotations(w: np.ndarray) -> np.ndarray:
    from popsift_tpu_torch.sfm.rotation import exp_so3
    return exp_so3(torch.from_numpy(np.asarray(w, np.float32))).numpy()


def _project(cams: np.ndarray, X: np.ndarray, obs_cam, obs_pt):
    """(uv, depth) of each observation through world->camera (rotvec, t)
    with BA_INTR."""
    f, _, cx, cy = BA_INTR
    R = _rotations(cams[:, :3]).astype(np.float64)
    Xc = np.einsum("oij,oj->oi", R[obs_cam], X[obs_pt]) + cams[obs_cam, 3:]
    uv = np.stack([f * Xc[:, 0] / Xc[:, 2] + cx, f * Xc[:, 1] / Xc[:, 2] + cy],
                  1)
    return uv, Xc[:, 2]


def ba_scene(seed: int, noise_px: float = 0.0, outliers: float = 0.0,
             n_cams: int = BA_CAMS, n_points: int = BA_POINTS,
             views: int = BA_VIEWS):
    """A BA problem with real geometry: cameras on a 180-degree arc of
    radius 8 round points in a 4 x 4 x 4 cube, each looking at the
    centre with a small tilt and roll; each point seen by ``views``
    cameras drawn at random; every point in front of its cameras. The
    start is perturbed as tests/test_sfm.py::_make_ba_problem perturbs
    it (cameras by 0.01, points by 0.05, camera 0 exact and fixed);
    ``outliers`` of the observations moved by N(0, 80 px). Returns (the
    problem's fields as numpy arrays, true cameras)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n_points, 3))
    a = np.linspace(-np.pi / 2, np.pi / 2, n_cams)
    i = np.arange(n_cams)
    w = np.stack([0.05 * np.sin(3.1 * i + 0.5), a,
                  0.05 * np.cos(2.3 * i)], 1).astype(np.float32)
    C = np.stack([8 * np.sin(a), 0.5 * np.sin(2 * a + 1.0), -8 * np.cos(a)],
                 1)
    R = _rotations(w).astype(np.float64)
    cams_gt = np.concatenate([w, -np.einsum("nij,nj->ni", R, C)], 1
                             ).astype(np.float32)
    obs_cam = np.argsort(rng.random((n_points, n_cams)), 1)[:, :views]
    obs_cam = obs_cam.reshape(-1)
    obs_pt = np.repeat(np.arange(n_points), views)
    uv, depth = _project(cams_gt, X, obs_cam, obs_pt)
    check(bool((depth > 0).all()), "a BA scene point lies behind a camera")
    if noise_px:
        uv += rng.normal(0, noise_px, uv.shape)
    if outliers:
        bad = rng.choice(len(uv), int(outliers * len(uv)), replace=False)
        uv[bad] += rng.normal(0, 80.0, (len(bad), 2))
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    fields = dict(cams=cams0, points=(X + rng.normal(0, 0.05, X.shape)),
                  intr=np.array(BA_INTR), obs_cam=obs_cam, obs_pt=obs_pt,
                  obs_uv=uv, obs_valid=np.ones(len(uv), bool),
                  cam_fixed=fixed)
    return fields, cams_gt


def focal_scene():
    """tests/test_sfm.py:163-209's scene (8 tilted cameras round 80
    points, seed 11), the shared focal 5 % off."""
    rng = np.random.default_rng(11)
    f = 500.0
    n_cams, n_pts = 8, 80
    X = rng.uniform([-2, -2, -2], [2, 2, 2],
                    size=(n_pts, 3)).astype(np.float32)
    cams_gt = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams * 0.35
        C = np.array([8 * np.sin(ang), 3.0 * np.sin(2 * ang + 1.0),
                      -8 * np.cos(ang)], np.float32)
        w = np.array([0.25 * np.sin(3.1 * i + 0.5), ang,
                      0.1 * np.cos(2.3 * i)], np.float32)
        R = _rotations(w[None])[0]
        cams_gt.append(np.concatenate([w, (-R @ C).astype(np.float32)]))
    cams_gt = np.stack(cams_gt)
    obs_cam = np.repeat(np.arange(n_cams), n_pts)
    obs_pt = np.tile(np.arange(n_pts), n_cams)
    uv = np.concatenate([
        _project(cams_gt[ci:ci + 1], X, np.zeros(n_pts, int),
                 np.arange(n_pts))[0] + rng.normal(0, 0.2, (n_pts, 2))
        for ci in range(n_cams)])
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(cams=cams0, points=X0,
                intr=np.array([f * 1.05, f * 1.05, 320.0, 240.0]),
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv,
                obs_valid=np.ones(len(uv), bool), cam_fixed=fixed), f


def pnp_scene(seed: int, B: int = PNP_B, rows: int = PNP_ROWS,
              n_valid: int = PNP_VALID):
    """B images for ransac_pnp_batch: each a random pose and about
    ``n_valid`` valid rows (of ``rows``) of points 4-8 in front of the
    camera, a quarter of them outliers uniform in [-0.5, 0.5], the
    inliers' normalized coordinates with N(0, 1e-3) noise (as
    tests/test_cv2_sfm_parity.py:110-120). Returns (X [B,N,3], x [B,N,2],
    valid [B,N], inlier truth [B,N], R [B,3,3], t [B,3], the median
    depth of each image's points [B])."""
    rng = np.random.default_rng(seed)
    Xs, xs, vs, truth, Rs, ts, depth = [], [], [], [], [], [], []
    for _ in range(B):
        w = rng.normal(0, 0.3, 3)
        R = _rotations(w[None])[0].astype(np.float64)
        t = rng.uniform([-1, -1, -1], [1, 1, 1])
        Xc = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (rows, 3))
        X = (Xc - t) @ R                       # world points: R^T (Xc - t)
        x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (rows, 2))
        out = rng.random(rows) < 0.25
        x[out] = rng.uniform(-0.5, 0.5, (int(out.sum()), 2))
        valid = np.arange(rows) < n_valid + int(rng.integers(-100, 101))
        Xs.append(X)
        xs.append(x)
        vs.append(valid)
        truth.append(valid & ~out)
        Rs.append(R)
        ts.append(t)
        depth.append(np.median(Xc[:, 2]))
    f32 = lambda a: torch.from_numpy(np.stack(a).astype(np.float32))
    return (f32(Xs), f32(xs), torch.from_numpy(np.stack(vs)),
            np.stack(truth), np.stack(Rs), np.stack(ts), np.array(depth))


def _ba_bound_ms(n_cams: int, n_points: int, n_obs: int, kind: str,
                 cg_iters: int = 25) -> tuple:
    """The least time one GN step could take (see :func:`bound_ms`).
    Dense: the Schur product B = (6 Nc x 3 Np) (3 Np x 6 Nc), 2 (6 Nc)^2
    3 Np f32 operations; the step's inputs and outputs are a few MB.
    CG: each of the cg_iters + 1 applications of S reads Jc and Jp (72
    bytes an observation) and gathers a camera (24) and a point (12)
    block for each observation; the step reads the observations (uv,
    two i64 indices, valid: 25 bytes) and writes Jc and Jp once (72)."""
    if kind == "dense":
        n_ops = 2.0 * (6 * n_cams) ** 2 * 3 * n_points
        n_bytes = n_obs * 25 + (n_cams * 6 + n_points * 3) * 4 * 2
    else:
        n_ops = (cg_iters + 1) * n_obs * 100.0
        n_bytes = (cg_iters + 1) * n_obs * 108.0 + n_obs * (25 + 72)
    return bound_ms(n_bytes, n_ops)


def _gap(got, ref) -> float:
    """max |got - ref| / max |ref| (got moved to ref's device)."""
    ref = ref.double()
    return float((got.to(ref.device).double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def step_scene(n_cams: int = BA_CAMS, n_points: int = BA_POINTS) -> dict:
    """Phase 9's GN-step problem: ``ba_scene(1)`` with 0.5 px noise and
    camera 1 held too, so that the scale gauge is fixed (with only camera
    0 fixed, S's smallest eigenvalue is lam and the step along that
    direction is rounding, ROADMAP C)."""
    fields, _ = ba_scene(1, noise_px=0.5, n_cams=n_cams, n_points=n_points)
    fixed = fields["cam_fixed"].copy()
    fixed[1] = True
    return dict(fields, cam_fixed=fixed)


def as_f64(p):
    """A BAProblem with its float fields in f64."""
    return p._replace(**{k: getattr(p, k).double()
                         for k in ("cams", "points", "intr", "obs_uv")})


def gn_steps(B) -> dict:
    return {"dense": lambda p, lam: B.schur_dense_step(p, lam),
            "cg": lambda p, lam: B.schur_cg_step(p, lam, cg_iters=25)}


def gn_norm_gap(jac, got, ref, lam: float) -> float:
    """|d|_H / |ref|_H for the step d = got - ref (each (dc, dp, ...)),
    |d|_H^2 = |J d|^2 + lam |d|^2, with ``jac`` = (Jc, Jp, obs_cam,
    obs_pt) in f64 on the CPU: the norm the GN model weighs a step by."""
    Jc, Jp, cam, pt = jac

    def h2(dc, dp):
        Jd = (torch.einsum("oki,oi->ok", Jc, dc[cam])
              + torch.einsum("oki,oi->ok", Jp, dp[pt]))
        return (Jd ** 2).sum() + lam * ((dc ** 2).sum() + (dp ** 2).sum())

    g, r = ([a.cpu().double() for a in x[:2]] for x in (got, ref))
    return float((h2(g[0] - r[0], g[1] - r[1]) / h2(*r)).sqrt())


def gn_step_gaps(got, got64, ref, exact, jac, lam: float) -> dict:
    """A GN step on the card (``got`` in f32, ``got64`` in f64) against the
    CPU's (``ref`` in f32, ``exact`` in f64). In f32 the step's largest
    entries are fixed by the arithmetic only to about 1e-2 at phase 9's
    size: the CPU's own f32 step moves by up to 2.6e-2 x its max when the
    observations are merely reordered, and the card's atomic sums take
    another order on every run (``tools/step_spread.py``). So the gaps
    that hold the card are the f64 steps' (the same function, entry for
    entry) and the f32 step's to the f64 step in the GN model's norm,
    which rounding along S's weak directions hardly moves; the
    largest-entry gaps are readings."""
    return dict(
        f64_card_cpu={"dc": _gap(got64[0], exact[0]),
                      "dp": _gap(got64[1], exact[1])},
        h_norm={"card_f64": gn_norm_gap(jac, got, exact, lam),
                "cpu_f64": gn_norm_gap(jac, ref, exact, lam)},
        card_cpu={"dc": _gap(got[0], ref[0]), "dp": _gap(got[1], ref[1])},
        f32_f64={"dc": _gap(ref[0], exact[0]), "dp": _gap(ref[1], exact[1])})


def _cost(B, p) -> float:
    return float(B.robust_cost(B.residuals(p)))


def _ate_of(E, cams, cams_gt) -> float:
    return E.ate_rmse(E.camera_centers(cams.cpu().numpy()),
                      E.camera_centers(cams_gt))


def _sync_sites(fn, dev) -> dict:
    """The host syncs of one ``fn()`` on the card, by the source line that
    asked for them (sync debug mode "warn"); {} on the CPU."""
    if dev.type != "cuda":
        fn()
        return {}
    sync(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync(dev)
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return dict(sites)


def sfm_phase(dev, reps: int = 5, n_cams: int = BA_CAMS,
              n_points: int = BA_POINTS, pnp_b: int = PNP_B,
              pnp_rows: int = PNP_ROWS, pnp_valid: int = PNP_VALID,
              table_dir: str | None = None) -> dict:
    """Bundle adjustment and PnP on the card at the BA benchmark's size,
    each against the port's run on the CPU from the same start (and the
    same ranks), with its times, bounds, launches and host syncs; with
    ``table_dir`` the profiler table of each timed call is written
    there."""
    from popsift_tpu_torch.sfm import ba as B
    from popsift_tpu_torch.sfm import evaluate as E
    from popsift_tpu_torch.sfm import pnp as P

    cpu = torch.device("cpu")
    size = dict(n_cams=n_cams, n_points=n_points)
    out = {}

    # one GN step of each kind on the card against the CPU (see
    # step_scene and gn_step_gaps): the same function in f64, entry for
    # entry; the f32 step against the f64 step in the GN model's norm
    pc, pd = (B.problem_from_numpy(step_scene(n_cams, n_points), d)
              for d in (cpu, dev))
    p64, pd64 = as_f64(pc), as_f64(pd)
    lam = {d: torch.full((), 1e-3, device=d) for d in (cpu, dev)}
    n_obs = int(pc.obs_cam.shape[0])
    check(B.dense_schur_feasible(n_cams, n_points),
          "the dense Schur path does not fit the problem")
    jac = (*B._jacobians(p64), pc.obs_cam, pc.obs_pt)
    for kind, step in gn_steps(B).items():
        ref = step(pc, lam[cpu])
        exact = step(p64, lam[cpu].double())
        got = step(pd, lam[dev])
        g = gn_step_gaps(got, step(pd64, lam[dev].double()), ref, exact,
                         jac, 1e-3)
        cost_gap = abs(float(got[2]) - float(ref[2])) / float(ref[2])
        f64, h, gaps, floor = (g["f64_card_cpu"], g["h_norm"], g["card_cpu"],
                               g["f32_f64"])
        say(f"{kind} GN step, {n_cams} cameras / {n_points} points / "
            f"{n_obs} observations: in f64 card against CPU dc "
            f"{f64['dc']:.3g} and dp {f64['dp']:.3g} x the step's max; in "
            f"f32 cost {cost_gap:.3g} relative, the f32 step against the "
            f"f64 step in the GN model's norm {h['card_f64']:.3g} on the "
            f"card, {h['cpu_f64']:.3g} on the CPU; largest entries: card "
            f"against CPU dc {gaps['dc']:.3g} and dp {gaps['dp']:.3g}, the "
            f"CPU's f32 step against its f64 step dc {floor['dc']:.3g}, dp "
            f"{floor['dp']:.3g}")
        check(all(v <= 1e-9 for v in f64.values()),
              f"{kind} step in f64: {f64} off the CPU's")
        check(cost_gap <= 1e-5, f"{kind} step: cost {cost_gap} off the CPU's")
        check(h["card_f64"] <= 1e-3 and all(
            bool(torch.isfinite(a).all()) for a in got[:2]),
            f"{kind} step in f32: {h['card_f64']} off the f64 step in the "
            f"GN model's norm")
        out[f"{kind}_step_gap"] = g

    # bundle_adjust(iters=10) on both paths: converges without noise,
    # reaches the noise floor's ATE with 0.5 px, ends at the CPU's cost
    paths = {"dense": dict(), "cg": dict(dense=False, cg_iters=25)}
    for noise in (0.0, 0.5):
        fields, cams_gt = ba_scene(2, noise_px=noise, **size)
        pd = B.problem_from_numpy(fields, dev)
        cost0 = _cost(B, pd)
        C = E.camera_centers(cams_gt)
        extent = float(np.linalg.norm(C.max(0) - C.min(0)))
        for name, kw in paths.items():
            res, costs = B.bundle_adjust(pd, iters=10, **kw)
            cost1 = _cost(B, res)
            ate = _ate_of(E, res.cams, cams_gt)
            say(f"bundle_adjust {name}, {noise} px: cost {cost0:.6g} -> "
                f"{cost1:.6g}, ATE {ate:.4g} over a {extent:.3g} extent")
            check(bool(torch.isfinite(costs).all()), f"{name}: non-finite cost")
            if noise == 0.0:
                check(cost1 < 1e-4 * cost0, f"bundle_adjust {name} did not "
                      f"converge: {cost0} -> {cost1}")
                continue
            check(ate <= 1e-3 * extent, f"bundle_adjust {name}: ATE {ate} "
                  f"over a {extent} extent")
            ref, _ = B.bundle_adjust(B.problem_from_numpy(fields, cpu),
                                     iters=10, **kw)
            ref_cost = _cost(B, ref)
            gap = abs(cost1 - ref_cost) / ref_cost
            say(f"bundle_adjust {name}, {noise} px: final cost {cost1:.8g} "
                f"on the card, {ref_cost:.8g} on the CPU ({gap:.3g} "
                f"relative)")
            check(gap <= 1e-3, f"bundle_adjust {name}: final cost {gap} off "
                  f"the CPU's")

    # Huber against L2 with 5 % of the observations 80 px off
    fields, cams_gt = ba_scene(3, noise_px=0.3, outliers=0.05, **size)
    pd = B.problem_from_numpy(fields, dev)
    ate_l2 = _ate_of(E, B.bundle_adjust(pd, iters=10)[0].cams, cams_gt)
    for name, kw in paths.items():
        res, costs = B.bundle_adjust(pd, iters=10, huber_delta=1.0, **kw)
        ate_h = _ate_of(E, res.cams, cams_gt)
        say(f"bundle_adjust {name}, Huber 1.0, 5 % outliers: ATE {ate_h:.4g}"
            f" against L2's {ate_l2:.4g}")
        check(float(costs[-1]) <= float(costs[0]) and ate_h < ate_l2 / 10,
              f"Huber {name}: ATE {ate_h} against L2's {ate_l2}")

    # the shared focal, dense joint solve, on the card against the CPU
    ffields, f_true = focal_scene()
    focal = {}
    for d in (cpu, dev):
        res, costs = B.bundle_adjust(B.problem_from_numpy(ffields, d),
                                     iters=20, opt_intr=True,
                                     intr_mask=(1.0, 1.0, 0.0, 0.0))
        focal[d.type] = (res.intr.cpu().numpy(), float(costs[-1]))
    (fi_d, c_d), (fi_c, c_c) = focal[dev.type], focal["cpu"]
    f_err = float(np.abs(fi_d[:2] - f_true).max() / f_true)
    f_gap = float(np.abs(fi_d - fi_c).max() / f_true)
    say(f"opt_intr focal scene: focal {fi_d[:2].tolist()} (true {f_true}, "
        f"{f_err:.3g} off), the CPU's {fi_c[:2].tolist()} ({f_gap:.3g} "
        f"relative), final cost {c_d:.6g} / CPU {c_c:.6g}")
    check(f_err < 0.005 and f_gap <= 1e-4
          and abs(c_d - c_c) <= 1e-3 * c_c and bool(
              np.array_equal(fi_d[2:], ffields["intr"][2:].astype(
                  np.float32))), "opt_intr: focal off the truth or the CPU's")

    # no host sync in the loop; two runs on the card, bit for bit?
    fields, cams_gt = ba_scene(2, noise_px=0.5, **size)
    pd = B.problem_from_numpy(fields, dev)
    runs = {}
    for name, kw in paths.items():
        B.bundle_adjust(pd, iters=10, **kw)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            r1 = B.bundle_adjust(pd, iters=10, **kw)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        r2 = B.bundle_adjust(pd, iters=10, **kw)
        same = all(torch.equal(a, b) for a, b in zip(r1[0], r2[0])) \
            and torch.equal(r1[1], r2[1])
        diff = max(_gap(a, b) for a, b in zip(r1[0][:3], r2[0][:3]))
        runs[name] = same
        say(f"bundle_adjust {name}: ran under sync debug mode \"error\" (0 "
            f"host syncs); two runs on the card bit-equal: {same} (largest "
            f"difference {diff:.3g} x the field's max)")
    out["ba_runs_bit_equal"] = runs

    # PnP at IncrementalSfM's batch shape: the card against the CPU from the
    # same ranks, the truth
    X, x, valid, truth, R_gt, t_gt, depth = pnp_scene(4, pnp_b, pnp_rows,
                                                      pnp_valid)
    ranks = P.draw_ranks(torch.Generator().manual_seed(5), valid, 256, 6)
    args = dict(thresh=PNP_THRESH, n_hyp=256, refine_iters=10)
    ref = P.ransac_pnp_batch(None, X, x, valid, ranks=ranks, **args)
    Xd, xd, vd, rd = X.to(dev), x.to(dev), valid.to(dev), ranks.to(dev)
    got = P.PnPResult(*(a.cpu() for a in P.ransac_pnp_batch(
        None, Xd, xd, vd, ranks=rd, **args)))

    def pose_gap(a, b):
        return (float((a.R - b.R).abs().max()),
                float(((a.t - b.t).norm(dim=1) / b.t.norm(dim=1)).max()))

    # the refinement fits the winning hypothesis's inliers, so the pose
    # depends on which hypothesis wins, and the card's SVDs give some
    # null vectors the other sign (pnp.py's docstring): the card is held
    # to 1e-4 or to the spread of the CPU's own poses over two more rank
    # draws, whichever is larger
    spread = [pose_gap(P.ransac_pnp_batch(
        torch.Generator().manual_seed(seed), X, x, valid, **args), ref)
        for seed in (6, 7)]
    R_tol = max(1e-4, max(g[0] for g in spread))
    t_tol = max(1e-4, max(g[1] for g in spread))
    R_err, t_err = pose_gap(got, ref)
    # rows whose error under the CPU's pose lies within 1 % of the gate may
    # fall either side
    e_ref = torch.stack([P.reprojection_error2(ref.R[b:b + 1], ref.t[b:b + 1],
                                               X[b], x[b])[0]
                         for b in range(pnp_b)])
    near = (e_ref - PNP_THRESH).abs() <= 0.01 * PNP_THRESH
    differ = got.inliers != ref.inliers
    n_valid = int(valid.sum())
    say(f"ransac_pnp_batch B={pnp_b} x {pnp_rows} rows ({n_valid} valid, "
        f"thresh {PNP_THRESH}): card against CPU R {R_err:.3g}, t "
        f"{t_err:.3g} x |t| (the CPU against itself from other ranks: R "
        f"{R_tol:.3g}, t {t_tol:.3g}), inlier masks differ on "
        f"{int(differ.sum())} rows ({int((differ & ~near).sum())} off the "
        f"gate's 1 % band)")
    check(R_err <= R_tol and t_err <= t_tol, f"PnP: card against CPU R "
          f"{R_err}, t {t_err}")
    check(not bool((differ & ~near).any())
          and int(differ.sum()) <= 1e-3 * n_valid,
          f"PnP: inlier masks differ on {int(differ.sum())} rows")
    ang = [float(np.arccos(np.clip((np.trace(R_gt[b] @ got.R[b].double()
                                             .numpy().T) - 1) / 2, -1, 1)))
           for b in range(pnp_b)]
    # translation against the scene's scale: the inliers' 1e-3 noise puts
    # |t - t_true| at 0.5-3.5e-3 for points 4-8 deep
    terr = [float(np.linalg.norm(got.t[b].double().numpy() - t_gt[b])
                  / depth[b]) for b in range(pnp_b)]
    recall = float((got.inliers.numpy() & truth).sum() / truth.sum())
    say(f"PnP against the truth: rotation {max(ang):.3g} rad, |t - t_true| "
        f"{max(terr):.3g} x the median depth at most; {recall:.4f} of the "
        f"true inliers kept")
    check(max(ang) <= 1e-3 and max(terr) <= 1e-3,
          f"PnP pose off the truth: {max(ang)} rad, {max(terr)} x depth")
    pnp_syncs = _sync_sites(lambda: P.ransac_pnp_batch(
        None, Xd, xd, vd, ranks=rd, **args), dev)
    say(f"ransac_pnp_batch host syncs in one call: "
        f"{sum(pnp_syncs.values())}, by source line {pnp_syncs}")
    out["pnp_syncs"] = pnp_syncs

    # times (CUDA events, median of reps), bounds, one profiler pass each
    pd = B.problem_from_numpy(fields, dev)
    ld = torch.full((), 1e-3, device=dev)
    bounds = {k: _ba_bound_ms(n_cams, n_points, n_obs, k)
              for k in ("dense", "cg")}
    timed = {
        "bundle_adjust_dense": (lambda: B.bundle_adjust(pd, iters=10),
                                10 * bounds["dense"][0], bounds["dense"][1]),
        "bundle_adjust_cg": (lambda: B.bundle_adjust(pd, iters=10,
                                                     dense=False),
                             10 * bounds["cg"][0], bounds["cg"][1]),
        "schur_dense_step": (lambda: B.schur_dense_step(pd, ld),
                             *bounds["dense"]),
        "schur_cg_step": (lambda: B.schur_cg_step(pd, ld), *bounds["cg"]),
        # scoring B x n_hyp x N (about 20 operations a pair) bounds it
        "ransac_pnp_batch": (lambda: P.ransac_pnp_batch(
            None, Xd, xd, vd, ranks=rd, **args),
            *bound_ms(X.numel() * 4 * 2, pnp_b * 256 * pnp_rows * 20.0)),
    }
    times = {}
    for name, (fn, b_ms, b_by) in timed.items():
        ms = median_ms(fn, dev, reps, 1)
        table = (os.path.join(table_dir, f"profile_{name}.txt")
                 if table_dir else None)
        counts = profile_counts(fn, dev, table)
        idle = 1.0 - counts["device_busy_ms"] / ms
        times[name] = dict(ms=round(ms, 4), bound_ms=round(b_ms, 4),
                           bound_by=b_by,
                           launch_calls=counts["launch_calls"],
                           device_ops=counts["device_ops"],
                           device_busy_ms=counts["device_busy_ms"],
                           device_idle=round(idle, 4),
                           stream_syncs=counts["stream_syncs"])
        say(f"{name}: {ms:.3f} ms (CUDA events, median of {reps}), bound "
            f"{b_ms:.4f} ms ({b_by}); one profiler pass: "
            f"{counts['launch_calls']} launch calls, {counts['device_ops']} "
            f"device ops, busy {counts['device_busy_ms']} ms, idle "
            f"{idle:.1%}, {counts['stream_syncs']} stream syncs")
        if name != "ransac_pnp_batch":
            check(counts["stream_syncs"] == 0, f"{name}: stream syncs")
    out["times"] = times
    say("phase 9 times: " + json.dumps(times))
    return out


# ---------------------------------------------------------------------------
# phase 10: the SfM drivers (sfm/incremental.py, sfm/global_sfm.py) at the
# JAX tests' sequence sizes (tests/test_sfm_scale.py, tests/test_global_sfm.py)
# ---------------------------------------------------------------------------

INC_CAMS, INC_POINTS = 200, 1200     # test_sequence_reconstruction_200_cams
LOCAL_CAMS = 80                           # test_local_ba_windowed_sequence
GLOBAL_CAMS = 40                          # test_global_sfm_end_to_end
CG_NODES = 12000                          # ..._cg_scales_to_10k_nodes
# how far the card's f32 translation solves may sit from the CPU's and from
# the f64 solve, in units of the solution's scale (see drivers_phase)
TRANSLATION_F32_TOL = 5e-4


def _recording(base):
    """``base`` (the port's IncrementalSfM) logging the ranks of every
    draw (``ranks``) and each PnP chunk's (image, n_inliers) (``inl``)."""
    class Recording(base):
        def _draw(self, valid, n_hyp, min_set):
            r = super()._draw(valid, n_hyp, min_set)
            self.__dict__.setdefault("ranks", []).append(r.cpu())
            return r

        def _pnp_eval_chunk(self, imgs):
            res = super()._pnp_eval_chunk(imgs)
            self.__dict__.setdefault("inl", []).extend(
                (img, n) for img, (_, _, n) in zip(imgs, res))
            return res
    return Recording


def _aligned_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest distance between ``b`` and ``a`` after the similarity
    (Umeyama) that best maps ``a`` onto ``b``."""
    from popsift_tpu_torch.sfm.evaluate import umeyama
    s, R, t = umeyama(a.astype(np.float64), b.astype(np.float64))
    return float(np.linalg.norm(a @ (s * R).T + t - b, axis=1).max())


def _extent(C: np.ndarray) -> float:
    return float(np.linalg.norm(C.max(0) - C.min(0)))


def _profiled(fn, dev) -> tuple:
    """One run of ``fn()`` under the profiler and sync debug mode "warn"
    at once: (its result, the pass's counts, host syncs by source line,
    wall ms of the run)."""
    box = {}

    def run():
        t0 = time.perf_counter()
        box["sites"] = _sync_sites(lambda: box.update(out=fn()), dev)
        box["ms"] = (time.perf_counter() - t0) * 1e3

    counts = profile_counts(run, dev)
    return box["out"], counts, box["sites"], box["ms"]


def _averaging_problems():
    """The inputs of tests/test_global_sfm.py's solver tests, from
    tools/sfm_scenes.py: 30 rotations (seed 0), the 24-node translation
    problem (seed 5) and the 12,000-node one (seed 9)."""
    from popsift_tpu_torch.tools.sfm_scenes import random_rotation, view_graph
    rng = np.random.default_rng(0)
    n = 30
    R_gt = np.stack([random_rotation(rng) for _ in range(n)])
    ei, ej = view_graph(rng, n)
    E = len(ei)
    R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei])
    noise = np.stack([random_rotation(rng, 0.005) for _ in range(E)])
    R_rel = np.einsum("eab,ebc->eac", noise, R_rel)
    bad = rng.choice(E, E // 10, replace=False)
    R_rel[bad] = np.stack([random_rotation(rng) for _ in bad])
    rot = (n, ei, ej, R_rel.astype(np.float32), R_gt)

    rng = np.random.default_rng(5)
    n = 24
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ei, ej = view_graph(rng, n)
    d = C_gt[ej] - C_gt[ei]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(0, 0.003, d.shape)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    small = (n, ei, ej, d)

    rng = np.random.default_rng(9)
    n = CG_NODES
    C_gt = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ei = np.arange(n, dtype=np.int32)
    ej = np.roll(ei, -1)
    ch_i = rng.integers(0, n, 3 * n).astype(np.int32)
    ch_j = rng.integers(0, n, 3 * n).astype(np.int32)
    keep = ch_i != ch_j
    ei = np.concatenate([ei, ch_i[keep]])
    ej = np.concatenate([ej, ch_j[keep]])
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
         ).astype(np.float32)
    return rot, small, (n, ei, ej, d, C_gt)


def translation_gaps(G, small, dev) -> tuple:
    """The 24-node translation problem solved dense and by CG on ``dev``,
    on the CPU in f32 and in f64: ({kind: the solve on ``dev``}, {kind:
    its gaps card against CPU, card against f64, CPU against f64, each the
    largest node distance over the f64 solve's scale})."""
    cpu = torch.device("cpu")
    n, ei, ej, d = small
    solves = {"dense": lambda *a: G.translation_averaging(n, *a)[0],
              "cg": lambda *a: G.translation_averaging_cg(
                  n, *a, cg_iters=400)[0]}
    res, gaps = {}, {}
    for kind, fn in solves.items():
        on = {dd: fn(*[torch.from_numpy(x).to(dd) for x in (ei, ej, d)])
              .cpu().numpy() for dd in (dev, cpu)}
        exact = fn(*[torch.from_numpy(x) for x in (ei, ej, d.astype(
            np.float64))]).numpy()
        scale = float(np.linalg.norm(exact - exact.mean(0), axis=1).mean())
        worst = lambda a, b: float(np.linalg.norm(a - b, axis=1).max()) / scale
        res[kind] = on[dev]
        gaps[kind] = dict(card_cpu=worst(on[dev], on[cpu]),
                          card_f64=worst(on[dev], exact),
                          cpu_f64=worst(on[cpu], exact))
    return res, gaps


def drivers_phase(dev, n_inc: int = INC_CAMS, n_inc_points: int = INC_POINTS,
                  n_local: int = LOCAL_CAMS, n_global: int = GLOBAL_CAMS
                  ) -> dict:
    """The SfM drivers on the card: ``IncrementalSfM`` against its CPU run
    from the same draws, at 200 cameras, with windowed local BA at 80 and
    checkpoint/resume; ``global_sfm`` at 40 cameras with its edge chunks
    timed and profiled; the averaging solvers. Each run's wall time, the
    200-camera run's split by device call, and one profiler pass of a
    ``register_next`` and of an edge chunk. Returns the times."""
    import tempfile

    from popsift_tpu_torch.sfm import evaluate as E
    from popsift_tpu_torch.sfm import global_sfm as G
    from popsift_tpu_torch.sfm import incremental as I
    from popsift_tpu_torch.tools import sfm_scenes as S
    from popsift_tpu_torch.tools.sfm_scale import DRIVER_CALLS, DeviceTimer

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    walls, out = {}, {}
    centers = S.camera_centers

    # 1. the card against the CPU from the same draws: the generator lives
    # on the host, so both runs draw the same ranks from the same seed
    # (held below); 5 cameras / 80 points, 0.3 px (no outliers)
    _, cams, kps = S.make_multiview(np.random.default_rng(7), 80, 5, 0.3)
    tracks = S.tracks_from_gt(kps, 80)
    gt = centers(cams, range(5))
    runs = {}
    for d in (dev, cpu):
        t0 = time.perf_counter()
        drv = _recording(I.IncrementalSfM)(tracks, S.INTR, device=d)
        pair = drv.initialize()
        R2, t2 = drv.rec.cam_R[pair[1]].copy(), drv.rec.cam_t[pair[1]].copy()
        while drv.register_next() is not None:
            pass
        costs = drv.global_ba(iters=8)
        C = centers(drv.rec, range(5))
        runs[d.type] = dict(pair=pair, R2=R2, t2=t2, inl=drv.inl,
                            order=list(drv.rec.registered), ranks=drv.ranks,
                            C=C, ate=E.ate_rmse(C, gt), costs=costs)
        walls[f"multiview_5_{d.type}"] = time.perf_counter() - t0
    a, b = runs[dev.type], runs["cpu"]
    same_ranks = len(a["ranks"]) == len(b["ranks"]) and all(
        torch.equal(x, y) for x, y in zip(a["ranks"], b["ranks"]))
    pose_gap = max(float(np.abs(a["R2"] - b["R2"]).max()),
                   float(np.abs(a["t2"] - b["t2"]).max()))
    c_gap = _aligned_gap(a["C"], b["C"]) / _extent(gt)
    say(f"incremental, 5 cameras / 80 points, card against CPU: "
        f"{len(a['ranks'])} draws equal: {same_ranks}; seed pair {a['pair']}"
        f" / {b['pair']}, R2 and t2 {pose_gap:.3g} apart; order "
        f"{a['order']} / {b['order']}; inliers {a['inl']} / {b['inl']}; "
        f"after global_ba(8) centers {c_gap:.3g} x the extent apart after "
        f"alignment, ATE {a['ate']:.4g} / {b['ate']:.4g}")
    check(same_ranks, "the card's and the CPU's runs drew different ranks")
    check(a["pair"] == b["pair"] and pose_gap <= 1e-4,
          f"seed pair {a['pair']} / {b['pair']}, R2/t2 {pose_gap} apart")
    check(a["order"] == b["order"] and a["inl"] == b["inl"],
          "registration order or inlier counts differ from the CPU's")
    check(c_gap <= 1e-3 and a["ate"] < 0.05 and b["ate"] < 0.05,
          f"centers {c_gap} x extent from the CPU's, ATE {a['ate']} / "
          f"{b['ate']}")

    # 2. incremental at 200 cameras / 1200 points
    # (test_sequence_reconstruction_200_cams), the time inside each device
    # call, one profiler pass of the second register_next
    rng = np.random.default_rng(13)
    _, cams, kps, vis = S.make_sequence(rng, n_pts=n_inc_points,
                                        n_cams=n_inc, noise=0.2)
    tracks = S.tracks_from_vis(kps, vis)
    timer = DeviceTimer(dev)
    for name in DRIVER_CALLS:
        timer.wrap(I, name)
    try:
        t0 = time.perf_counter()
        sfm = I.IncrementalSfM(tracks, S.INTR, ba_every=25, register_batch=8,
                               device=dev)
        sfm.initialize()
        t_init = time.perf_counter() - t0
        reg_ms, prof = [], None
        while True:
            n_before = len(sfm.rec.registered)
            t1 = time.perf_counter()
            if len(reg_ms) == 1:
                last, counts, sites, ms = _profiled(sfm.register_next, dev)
                prof = dict(counts, wall_ms=round(ms, 3), sync_sites=sites,
                            registered=len(sfm.rec.registered) - n_before)
            else:
                last = sfm.register_next()
            reg_ms.append((time.perf_counter() - t1) * 1e3)
            if last is None:
                reg_ms.pop()
                break
        costs = sfm.global_ba(iters=8)
        wall = time.perf_counter() - t0
    finally:
        timer.restore()
    reg = sorted(sfm.rec.registered)
    ate = E.ate_rmse(centers(sfm.rec, reg), centers(cams, reg))
    walls[f"incremental_{n_inc}"] = wall
    split = {k: dict(calls=c, s=round(s, 4))
             for k, (c, s) in sorted(timer.calls.items())}
    split["host_s"] = round(wall - timer.total, 4)
    prof["device_idle"] = round(1.0 - prof["device_busy_ms"]
                                / prof["wall_ms"], 4)
    out["incremental"] = dict(
        registered=len(reg), ate=ate, initialize_s=round(t_init, 4),
        register_next_ms_median=round(statistics.median(reg_ms), 3),
        register_next_calls=len(reg_ms), split=split, profile=prof)
    say(f"incremental, {n_inc} cameras / {n_inc_points} points: {len(reg)} "
        f"registered, global_ba(8) cost {costs[0]:.6g} -> {costs[-1]:.6g}, "
        f"ATE {ate:.4g}, {wall:.2f} s ({len(reg_ms)} register_next calls, "
        f"median {statistics.median(reg_ms):.1f} ms); inside the device "
        f"calls (CUDA events): {json.dumps(split)}")
    say(f"one register_next ({prof['registered']} images) under the "
        f"profiler: {prof['launch_calls']} launch calls, busy "
        f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.1f} (idle "
        f"{prof['device_idle']:.1%}), {prof['stream_syncs']} stream syncs; "
        f"host syncs by source line {sites}")
    check(len(reg) >= n_inc - 4, f"registered only {len(reg)}/{n_inc}")
    check(costs[-1] <= costs[0], f"global_ba cost rose: {costs}")
    check(ate < 0.5, f"ATE {ate}")

    # 3. windowed local BA at 80 cameras (test_local_ba_windowed_sequence),
    # then refine(rounds=2)
    rng = np.random.default_rng(13)
    _, cams, kps, vis = S.make_sequence(rng, n_cams=n_local, noise=0.2,
                                        span=0.25 * n_local + 10,
                                        vis_pts=240)
    tracks = S.tracks_from_vis(kps, vis)
    t0 = time.perf_counter()
    sfm = I.IncrementalSfM(tracks, S.INTR, ba_every=50, register_batch=8,
                           local_ba_window=12, device=dev)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    walls[f"local_ba_{n_local}"] = time.perf_counter() - t0
    reg = sorted(sfm.rec.registered)
    C_gt = centers(cams, reg)
    ate = E.ate_rmse(centers(sfm.rec, reg), C_gt)
    culled = []
    cull = sfm.cull_points

    def counted_cull(*a, **k):
        culled.append(cull(*a, **k))
        return culled[-1]

    sfm.cull_points = counted_cull
    t0 = time.perf_counter()
    sfm.refine(rounds=2)
    walls[f"refine_{n_local}"] = time.perf_counter() - t0
    ate_r = E.ate_rmse(centers(sfm.rec, reg), C_gt)
    say(f"local BA, {n_local} cameras (window 12): {len(reg)} registered, "
        f"ATE {ate:.4g} over a {_extent(C_gt):.3g} extent; refine(2): "
        f"culled {culled} points, ATE {ate_r:.4g}, {len(sfm.rec.points)} "
        f"points")
    check(len(reg) >= n_local - 4, f"registered only {len(reg)}/{n_local}")
    check(ate < 0.01 * _extent(C_gt) and ate_r < 0.01 * _extent(C_gt),
          f"ATE {ate} / after refine {ate_r} over {_extent(C_gt)}")
    out["local_ba"] = dict(registered=len(reg), ate=ate, ate_refined=ate_r,
                           culled=culled)

    # 4. global SfM at 40 cameras (test_global_sfm_end_to_end), each edge
    # chunk timed, one profiler pass of the first
    rng = np.random.default_rng(2)
    _, cams, kps, vis = S.make_sequence(rng, n_cams=n_global)
    tracks = S.tracks_from_vis(kps, vis)
    chunks = []
    solve = G.solve_pairs_batch

    def timed_chunk(*a, **k):
        res, s = timer.elapsed(solve, a, k)
        chunks.append((s * 1e3, a, k))
        return res

    G.solve_pairs_batch = timed_chunk
    try:
        t0 = time.perf_counter()
        drv = G.global_sfm(tracks, S.INTR, min_covis=30, max_edges=120,
                           device=dev)
        walls[f"global_{n_global}"] = time.perf_counter() - t0
    finally:
        G.solve_pairs_batch = solve
    reg = sorted(drv.rec.registered)
    ate = E.ate_rmse(centers(drv.rec, reg), centers(cams, reg))
    _, a0, k0 = chunks[0]
    solve(*a0, **k0)
    sync(dev)
    _, counts, sites, ms = _profiled(lambda: solve(*a0, **k0), dev)
    chunk = dict(chunks=len(chunks), edges=G.EDGE_CHUNK,
                 rows=int(a0[1].shape[1]),
                 ms_median=round(statistics.median(c[0] for c in chunks), 3),
                 ms_each=[round(c[0], 3) for c in chunks],
                 launch_calls=counts["launch_calls"],
                 device_ops=counts["device_ops"],
                 device_busy_ms=counts["device_busy_ms"],
                 wall_ms_profiled=round(ms, 3),
                 device_idle=round(1.0 - counts["device_busy_ms"] / ms, 4),
                 stream_syncs=counts["stream_syncs"], sync_sites=sites)
    out["global"] = dict(registered=len(reg), ate=ate,
                         points=len(drv.rec.points), solve_pairs_batch=chunk)
    say(f"global SfM, {n_global} cameras: {len(reg)} registered, "
        f"{len(drv.rec.points)} points, ATE {ate:.4g}, "
        f"{walls[f'global_{n_global}']:.2f} s; solve_pairs_batch: "
        f"{json.dumps(chunk)}")
    check(len(reg) == n_global, f"global SfM registered {len(reg)}")
    check(ate < 0.5, f"global SfM ATE {ate}")

    # 5. the averaging solvers
    rot, small, big = _averaging_problems()
    n, ei, ej, d, C_gt = big
    args = [torch.from_numpy(x).to(dev) for x in (ei, ej, d)]
    t0 = time.perf_counter()
    C = G.translation_averaging_cg(n, *args, iters=2, cg_iters=80)[0]
    C = C.cpu().numpy()
    walls[f"translation_cg_{n}"] = time.perf_counter() - t0
    _, counts, _, ms = _profiled(lambda: G.translation_averaging_cg(
        n, *args, iters=2, cg_iters=80)[0].cpu(), dev)
    s, R, t = E.umeyama(C.astype(np.float64), C_gt.astype(np.float64))
    errs = np.linalg.norm(C @ (s * R).T + t - C_gt, axis=1)
    spread = float(np.linalg.norm(C_gt - C_gt.mean(0), axis=1).mean())
    cg_big = dict(nodes=n, edges=len(ei), median_err=float(np.median(errs)),
                  spread=spread, launch_calls=counts["launch_calls"],
                  device_busy_ms=counts["device_busy_ms"],
                  wall_ms_profiled=round(ms, 3),
                  device_idle=round(1.0 - counts["device_busy_ms"] / ms, 4))
    say(f"translation_averaging_cg, {n} nodes / {len(ei)} edges, 2 x 80 CG "
        f"iterations: median error {np.median(errs):.4g} after alignment "
        f"(spread {spread:.4g}); {json.dumps(cg_big)}")
    check(np.isfinite(C).all() and np.median(errs) < 0.05 * spread,
          f"CG at {n} nodes: median error {np.median(errs)}")

    # dense and CG on the 24-node problem: the card against each other and
    # against its CPU run. The 1e6 gauge pin leaves the f32 systems badly
    # conditioned: the CPU's own f32 solves sit 1.1e-4 (dense) and 5.0e-5
    # (CG) x the scale from their f64 solve, and the card's LU and sums
    # round the same system otherwise (measured on the H100: 2.4e-4 and
    # 1.3e-4 from the CPU's), so each is held to TRANSLATION_F32_TOL, card
    # against CPU and card against the f64 solve
    res, gaps = translation_gaps(G, small, dev)
    scale = float(np.linalg.norm(res["dense"] - res["dense"].mean(0),
                                 axis=1).mean())
    dense_cg = float(np.linalg.norm(res["cg"] - res["dense"],
                                    axis=1).max()) / scale
    say(f"translation averaging, 24 nodes: on the card CG against dense "
        f"{dense_cg:.3g} x the scale; card against CPU and each against "
        f"the f64 solve: {json.dumps(gaps)}")
    check(dense_cg < 1e-2, f"CG against dense {dense_cg} x the scale")
    for kind, g in gaps.items():
        check(g["card_cpu"] <= TRANSLATION_F32_TOL
              and g["card_f64"] <= TRANSLATION_F32_TOL,
              f"{kind}: the card's solve off the CPU's or the f64 one: {g}")
    out["translation_24"] = dict(gaps, dense_cg=dense_cg)

    n, ei, ej, R_rel, R_gt = rot
    R = G.rotation_averaging(n, *[torch.from_numpy(x).to(dev) for x in
                                  (ei, ej, R_rel)])[0].cpu().numpy()
    R_ref = np.einsum("nab,cb->nac", R_gt, R_gt[0])
    cos = (np.einsum("nab,nab->n", R.astype(np.float64), R_ref) - 1) / 2
    errs = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    say(f"rotation averaging, 30 nodes: median error {np.median(errs):.3g} "
        f"deg, max {errs.max():.3g}")
    check(np.median(errs) < 0.5 and errs.max() < 3.0,
          f"rotation averaging: median {np.median(errs)}, max {errs.max()}")

    # 6. checkpoint and resume on the card (test_fault_injection_resume)
    _, cams, kps = S.make_multiview(np.random.default_rng(7), 60, 5, 0.0)
    tracks = S.tracks_from_gt(kps, 60)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        first = I.IncrementalSfM(tracks, S.INTR, checkpoint_dir=ck,
                                 device=dev)
        first.initialize()
        first.register_next()
        del first                         # the run stops here
        sfm = I.IncrementalSfM.resume(tracks, ck, device=dev)
        n_resumed = len(sfm.rec.registered)
        while sfm.register_next() is not None:
            pass
        sfm.global_ba(iters=8)
    ref = I.IncrementalSfM(tracks, S.INTR, device=dev)
    ref.initialize()
    while ref.register_next() is not None:
        pass
    ref.global_ba(iters=8)
    walls["resume_5"] = time.perf_counter() - t0
    gap = float(np.abs(centers(sfm.rec, range(5))
                       - centers(ref.rec, range(5))).max())
    say(f"checkpoint/resume on the card: resumed with {n_resumed} "
        f"registered, centers {gap:.3g} from an uninterrupted run, points "
        f"{len(sfm.rec.points)} / {len(ref.rec.points)}")
    check(n_resumed == 3 and len(sfm.rec.registered) == 5 and gap <= 1e-3
          and len(sfm.rec.points) == len(ref.rec.points),
          f"resume: {n_resumed} registered, centers {gap} apart")

    # 7. times
    walls["phase"] = time.perf_counter() - t_phase
    out["wall_s"] = {k: round(v, 3) for k, v in walls.items()}
    out["translation_cg_large"] = cg_big
    say("phase 10 times: " + json.dumps(out))
    return out


# phase 11: popsift-sfm on E2E_r05.json's scene (scripts/e2e_proof.py)
E2E_FRAMES, E2E_HW = 100, (240, 320)
E2E_TOP_M = 8                  # --retrieval 8, as the artifact's command
# The scene's ATE is a chaotic function of rounding and draws (ROADMAP C):
# popsift_tpu.cli.sfm with this command on a CPU registers 100 and ends at
# 5.47 % of the trajectory (its seed-0 draws; the artifact's 3.11 % is not
# reproduced; its driver from seeds 1-4 ends at 1.7-3.3 %), and the port's
# runs spread from 1.2 % to 23 % on the card, a seventh of them past 10.9 %.
# One run would test the draw, so the run is made from E2E_SEEDS draws
# (--seed) and their medians are gated: at least 98 registered, ATE at most
# twice JAX's or 5 %, whichever is larger (the rule of the --global check)
E2E_SEEDS = (0, 1, 2, 3, 4, 5, 6)
E2E_MIN_REGISTERED = 98
JAX_E2E_ATE_PCT = 5.471
E2E_MAX_ATE_PCT = max(2 * JAX_E2E_ATE_PCT, 5.0)
GLOBAL_E2E_FRAMES = 40         # phase 10's global_sfm size
# popsift_tpu.cli.sfm --global --retrieval 8 --min-covis 30 on the first 40
# frames, on a CPU (PERF.md §6): every camera, ATE 0.016431. Its
# global_sfm from seeds 0-5 on those tracks ends either near that (1.1-1.6
# % of the trajectory) or collapsed (27-29 %), three times each, and the
# port's runs split the same way; so --global runs from GLOBAL_SEEDS and
# the best ATE is gated, with the median registered count
GLOBAL_SEEDS = (0, 1, 2, 3, 4, 5, 6)
JAX_GLOBAL_REGISTERED, JAX_GLOBAL_ATE = 40, 0.016431
CLI_PARITY_FRAMES = 6
PAIR_NEAR_TIE = 0.005          # a pair's match count, card against CPU


class _StampedLines:
    """A stdout stand-in that keeps each printed line with the host clock
    at which it was completed."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, s: str) -> int:
        parts = (self._part + s).split("\n")
        self._part = parts.pop()
        now = time.perf_counter()
        self.lines += [(now, l) for l in parts]
        return len(s)

    def flush(self) -> None:
        pass


def _run_cli(main, argv: list) -> tuple:
    """(exit code, [(time, line)], start time) of one in-process CLI run
    with its standard output kept, not printed."""
    import contextlib
    out = _StampedLines()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    out.lines.append((time.perf_counter(), "<end>"))
    return rc, out.lines, t0


def _stage_walls(lines: list, t0: float) -> dict:
    """Seconds of each stage of a ``-v`` popsift-sfm run from the times
    its lines were printed: each stage ends with the last line it prints
    (extraction with the last ``image``, matching with the last ``pair``,
    registration with the last ``registered image``)."""
    def last(prefix):
        return max((t for t, l in lines if l.startswith(prefix)), default=None)
    marks = [("extraction", last("image ")),
             ("retrieval", last("retrieval shortlist:")),
             ("matching", last("pair (")), ("tracks", last("tracks:")),
             ("initialize", last("seed pair:") or last("global SfM:")),
             ("registration", last("registered image ")),
             ("final_ba", last("final BA cost:")),
             ("refine", last("refined BA cost:")),
             ("export", lines[-1][0])]
    walls, prev = {}, t0
    for name, t in marks:
        if t is not None:
            walls[name] = round(t - prev, 4)
            prev = t
    walls["total"] = round(lines[-1][0] - t0, 4)
    return walls


def _cli_counts(lines: list) -> dict:
    """The per-image keypoint counts, per-pair match counts and the track
    count a ``-v`` popsift-sfm run printed."""
    text = [l for _, l in lines]
    num = lambda l: int(re.search(r": (\d+)", l).group(1))
    return {"keypoints": [num(l) for l in text if l.startswith("image ")],
            "pairs": {l.split(":")[0]: num(l) for l in text
                      if l.startswith("pair (")},
            "tracks": [num(l) for l in text if l.startswith("tracks:")]}


def sfm_cli_phase(dev, n_frames: int = E2E_FRAMES, hw: tuple = E2E_HW,
                  n_global: int = GLOBAL_E2E_FRAMES,
                  n_parity: int = CLI_PARITY_FRAMES,
                  min_registered: int = E2E_MIN_REGISTERED,
                  seeds: tuple = E2E_SEEDS,
                  global_seeds: tuple = GLOBAL_SEEDS) -> dict:
    """popsift-sfm (``cli/sfm.py``) on the card on the scene of the JAX
    package's E2E artifact (``tools/e2e_proof.py::render_sequence``, 100
    frames of 240 x 320): (a) retrieval of the frames' descriptors on the
    card against the CPU; (b) the images-to-model run, ``--retrieval 8
    --refine`` and both exports, with the launch counters reset just
    before it, each stage's wall and one profiled ``register_next``, then
    the same command from the other ``seeds``, their median registered
    count and ATE gated; (c)
    ``--global`` on the first 40 frames from ``global_seeds``, against
    the JAX CLI's CPU result;
    (d) 6 frames on the card and on the CPU from the same ``--seed``.
    Returns the figures."""
    import tempfile

    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.cli import sfm as sfm_cli
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.eval.repeatability import \
        strongest_descriptor_per_keypoint
    from popsift_tpu_torch.io.image import write_pgm
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops.matching import match_descriptors
    from popsift_tpu_torch.sfm import incremental as I
    from popsift_tpu_torch.sfm import retrieval as R
    from popsift_tpu_torch.tools.e2e_proof import ate_report, render_sequence
    from popsift_tpu_torch.tools.sfm_scale import DeviceTimer

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    out = {}
    frames, gt, (fx, fy, cx, cy) = render_sequence(n_frames, *hw)
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    paths = []
    for i, fr in enumerate(frames):
        paths.append(os.path.join(work, f"frame_{i:04d}.pgm"))
        write_pgm(paths[-1], fr)
    intr = ["--fx", str(fx), "--fy", str(fy), "--cx", str(cx), "--cy",
            str(cy)]
    timer = DeviceTimer(dev)

    # (a) retrieval: the frames' strongest descriptors extracted on the
    # card as the CLI takes them, codebook, signatures and shortlist on the
    # card and on the CPU from the same sample and init scores
    ps = PopSift(SiftConfig(), device=dev)
    jobs = [ps.enqueue(fr) for fr in frames]
    descs = {i: strongest_descriptor_per_keypoint(j.get())[1]
             for i, j in enumerate(jobs)}
    res, ms = {}, {}
    for d in (dev, cpu):
        tm = DeviceTimer(d)
        c, s_c = tm.elapsed(R.train_codebook, (descs,), dict(device=d))
        s, s_s = tm.elapsed(R.build_signatures, (descs,), dict(device=d))
        p, s_p = tm.elapsed(R.pair_shortlist, (s,), dict(top_m=E2E_TOP_M,
                                                         device=d))
        v, s_v = tm.elapsed(R.vlad_signature, (descs[0], np.ones(
            len(descs[0]), bool), c), dict(device=d))
        res[d.type] = (c.cpu(), s.cpu(), p)
        ms[d.type] = dict(train_codebook=s_c * 1e3, build_signatures=s_s
                          * 1e3, pair_shortlist=s_p * 1e3,
                          vlad_signature_one_image=s_v * 1e3)
    (cc, sc, pc), (cr, sr, pr) = res[dev.type], res["cpu"]
    c_gap = float((cc - cr).abs().max() / cr.abs().max())
    s_gap = float((sc - sr).abs().max())
    vals = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0, -0.0, 0.0, 3.0])
    ties = R.top_k(vals.to(dev), 8).cpu().tolist()
    out["retrieval"] = dict(rows=sum(len(x) for x in descs.values()),
                            center_gap=c_gap, signature_gap=s_gap,
                            pairs=len(pc), ms=ms, top_k_ties=ties)
    say(f"retrieval, {n_frames} frames ({out['retrieval']['rows']} "
        f"descriptors): card against CPU, centers {c_gap:.3g} x the largest "
        f"entry apart, signatures {s_gap:.3g}, shortlist {len(pc)} / "
        f"{len(pr)} pairs, equal: {pc == pr}; top_k of ties on the card "
        f"{ties}; ms (CUDA events on the card, host clock on the CPU): "
        f"{json.dumps(ms)}")
    check(c_gap <= 1e-4, f"codebook {c_gap} x its max from the CPU's")
    check(s_gap <= 1e-5, f"signatures {s_gap} from the CPU's")
    check(pc == pr, "the card's shortlist differs from the CPU's")
    check(ties == [1, 2, 4, 7, 0, 3, 6, 5], f"top_k's tie order {ties}")

    # (b) the images-to-model run, as tools/e2e_proof.py runs it, with
    # the launch counters reset just before it and one register_next in the
    # middle profiled; then the same from the other seeds' draws
    rec = os.path.join(work, "rec.npz")
    sparse, ply = os.path.join(work, "sparse"), os.path.join(work, "c.ply")
    prof, calls = {}, []
    register_next = I.IncrementalSfM.register_next

    def profiled_register_next(self):
        calls.append(None)
        if len(calls) != n_frames // 2:
            return register_next(self)
        r, counts, sites, wall = _profiled(lambda: register_next(self), dev)
        prof.update(counts, wall_ms=round(wall, 3), sync_sites=sites,
                    device_idle=round(1 - counts["device_busy_ms"] / wall, 4))
        return r

    def e2e_run(seed, extra=()):
        rc, lines, t0 = _run_cli(sfm_cli.main, ["-i"] + paths + intr + [
            "--device", dev.type, "--retrieval", str(E2E_TOP_M), "--refine",
            "--seed", str(seed), "--export", rec, "-v", *extra])
        check(rc == 0, f"popsift-sfm --seed {seed} exited {rc}")
        return lines, t0, ate_report(rec, gt)

    I.IncrementalSfM.register_next = profiled_register_next
    try:
        kernels.reset_launch_counts()
        lines, t0, ate = e2e_run(seeds[0], ("--export-colmap", sparse,
                                            "--export-ply", ply))
        launches = kernels.launch_counts()
    finally:
        I.IncrementalSfM.register_next = register_next
    walls = _stage_walls(lines, t0)
    text = [l for _, l in lines]
    n_pairs = sum(l.startswith("pair (") for l in text)
    files = {f: os.path.getsize(os.path.join(sparse, f))
             for f in ("cameras.txt", "images.txt", "points3D.txt")}
    summary = [l for l in text if l.startswith(
        ("retrieval shortlist", "tracks:", "seed pair", "final BA",
         "refined BA"))]
    out["e2e"] = dict(walls_s=walls, pairs=n_pairs, ate=ate,
                      ms_per_pair=round(1e3 * walls["matching"] / n_pairs, 3),
                      launches={k: v for k, v in launches.items() if v},
                      register_next_profiled=prof, colmap_bytes=files,
                      ply_bytes=os.path.getsize(ply), lines=summary)
    say(f"popsift-sfm, {n_frames} frames of {hw[0]} x {hw[1]}, --retrieval "
        f"{E2E_TOP_M} --refine --seed {seeds[0]}: {summary}; "
        f"{ate['registered']}/{n_frames} registered, ATE {ate['rmse']:.4g} = "
        f"{ate['rmse_pct_of_traj']:.3g} % of the {ate['trajectory_length']:.3g}"
        f" trajectory; stage walls (s, host clock): {json.dumps(walls)}; "
        f"{n_pairs} pairs, {out['e2e']['ms_per_pair']} ms a pair; launches "
        f"{out['e2e']['launches']}; exports {files}, PLY "
        f"{out['e2e']['ply_bytes']} bytes")
    say(f"register_next #{n_frames // 2} under the profiler: "
        f"{json.dumps(prof)}")
    for name in ONCE + ("refine_octaves",):
        check(launches[name] == n_frames, f"{name} launched "
              f"{launches[name]} times for {n_frames} frames")
    for name in MAIN_PATH:
        check(launches[name] >= n_frames, f"{name} launched "
              f"{launches[name]} times for {n_frames} frames")
    check(all(v > 0 for v in files.values()) and out["e2e"]["ply_bytes"] > 0,
          f"exports {files}")
    check(bool(prof) and prof["launch_calls"] > 0,
          "no register_next was profiled")
    runs = [dict(seed=seeds[0], registered=ate["registered"],
                 ate_pct=ate["rmse_pct_of_traj"], wall_s=walls["total"])]
    for seed in seeds[1:]:
        lines, t0, a = e2e_run(seed)
        runs.append(dict(seed=seed, registered=a["registered"],
                         ate_pct=a["rmse_pct_of_traj"],
                         wall_s=round(lines[-1][0] - t0, 4)))
    med_reg = statistics.median(r["registered"] for r in runs)
    med_ate = statistics.median(r["ate_pct"] for r in runs)
    out["e2e"]["seeds"] = runs
    say(f"popsift-sfm from {len(runs)} seeds' draws: {json.dumps(runs)}; "
        f"median {med_reg} registered, ATE {med_ate:.3g} % of the trajectory "
        f"(gates: >= {min_registered}, <= {E2E_MAX_ATE_PCT:.3g} %; the JAX "
        f"CLI on a CPU: 100, {JAX_E2E_ATE_PCT} %)")
    check(med_reg >= min_registered,
          f"median registered {med_reg}/{n_frames}")
    check(med_ate <= E2E_MAX_ATE_PCT,
          f"median ATE {med_ate} % of the trajectory")

    # one pair of the matching loop, as the CLI runs it, under the profiler
    cap = max(256, 1 << (max(len(d) for d in descs.values()) - 1)
              .bit_length())

    def one_pair(i=0, j=1):
        on_dev = lambda a: torch.from_numpy(a).to(dev)
        r = match_descriptors(
            on_dev(sfm_cli.pad_to(descs[i], cap)),
            on_dev(np.arange(cap) < len(descs[i])),
            on_dev(sfm_cli.pad_to(descs[j], cap)),
            on_dev(np.arange(cap) < len(descs[j])))
        rows = np.nonzero(r.accept.cpu().numpy())[0]
        return r.best_idx.cpu().numpy()[rows]

    one_pair()
    _, counts, sites, wall = _profiled(one_pair, dev)
    out["e2e"]["pair_profiled"] = dict(
        counts, wall_ms=round(wall, 3), sync_sites=sites,
        device_idle=round(1 - counts["device_busy_ms"] / wall, 4))
    say(f"one pair of the matching loop ({cap} padded rows) under the "
        f"profiler: {json.dumps(out['e2e']['pair_profiled'])}")

    # (c) --global on the first 40 frames, the JAX CLI's command, from
    # each of global_seeds' draws
    rec_g = os.path.join(work, "rec_global.npz")
    glob = []
    for seed in global_seeds:
        rc, lines, t0 = _run_cli(sfm_cli.main, ["-i"] + paths[:n_global]
                                 + intr + ["--device", dev.type, "--global",
                                           "--retrieval", str(E2E_TOP_M),
                                           "--min-covis", "30", "--seed",
                                           str(seed), "--export", rec_g,
                                           "-v"])
        check(rc == 0, f"popsift-sfm --global --seed {seed} exited {rc}")
        a = ate_report(rec_g, gt[:n_global])
        glob.append(dict(seed=seed, registered=a["registered"],
                         ate=a["rmse"], ate_pct=a["rmse_pct_of_traj"],
                         wall_s=round(lines[-1][0] - t0, 4), lines=[
                             l for _, l in lines if l.startswith(
                                 ("tracks:", "global SfM"))]))
    max_ate = max(2 * JAX_GLOBAL_ATE, 0.05 * a["trajectory_length"])
    med_reg = statistics.median(g["registered"] for g in glob)
    best = min(g["ate"] for g in glob)
    out["global"] = dict(runs=glob, walls_s=_stage_walls(lines, t0))
    say(f"popsift-sfm --global, first {n_global} frames, from "
        f"{len(glob)} seeds' draws: {json.dumps(glob)}; median "
        f"{med_reg} registered, best ATE {best:.4g} (gates: >= "
        f"{min(JAX_GLOBAL_REGISTERED, n_global) - 2}, <= {max_ate:.4g}; the "
        f"JAX CLI on a CPU: {JAX_GLOBAL_REGISTERED}, {JAX_GLOBAL_ATE}); last "
        f"run's walls {json.dumps(out['global']['walls_s'])}")
    check(med_reg >= min(JAX_GLOBAL_REGISTERED, n_global) - 2,
          f"--global median registered {med_reg}")
    check(best <= max_ate, f"--global best ATE {best} above {max_ate}")

    # (d) the first 6 frames on the card and on the CPU, the same --seed
    runs = {}
    for d in (dev, cpu):
        r = os.path.join(work, f"rec6_{d.type}.npz")
        rc, lines, t0 = _run_cli(sfm_cli.main, ["-i"] + paths[:n_parity]
                                 + intr + ["--device", d.type, "--seed", "3",
                                           "--export", r, "-v"])
        check(rc == 0, f"popsift-sfm on {n_parity} frames on {d} exited {rc}")
        runs[d.type] = dict(_cli_counts(lines), wall=lines[-1][0] - t0,
                            registered=sorted(int(c) for c in
                                              np.load(r)["registered"]))
    a, b = runs[dev.type], runs["cpu"]
    gaps = {p: abs(a["pairs"][p] - n) / max(n, 1)
            for p, n in b["pairs"].items()}
    near = {p: (a["pairs"][p], b["pairs"][p]) for p, g in gaps.items() if g}
    out["parity"] = dict(card=a, cpu=b, near_ties=near)
    say(f"popsift-sfm, first {n_parity} frames, --seed 3, card against CPU: "
        f"keypoints {a['keypoints']} / {b['keypoints']}, tracks "
        f"{a['tracks']} / {b['tracks']}, pairs differing {near}, registered "
        f"{a['registered']} / {b['registered']}; {a['wall']:.2f} / "
        f"{b['wall']:.2f} s")
    check(a["keypoints"] == b["keypoints"], "keypoint counts differ")
    check(a["tracks"] == b["tracks"], "track counts differ")
    check(sorted(a["pairs"]) == sorted(b["pairs"])
          and max(gaps.values()) <= PAIR_NEAR_TIE,
          f"match counts differ past {PAIR_NEAR_TIE}: {near}")
    check(a["registered"] == b["registered"], "registered sets differ")

    tmp.cleanup()
    out["wall_s"] = round(time.perf_counter() - t_phase, 3)
    say(f"phase 11 took {out['wall_s']} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the multi-device layer (parallel/, sfm/distributed.py) at world
# size 1 (NCCL) and 2 (two processes sharing the card, gloo)
# ---------------------------------------------------------------------------

AP_ROWS = 4096        # all-pairs: each frame's first 4096 valid descriptors
AVG_NODES = 1000      # edge-sharded averaging: a chain plus 4 edges a node
BA_COST_TOL = 1e-3    # distributed BA's final cost against bundle_adjust's
ROTATION_TOL = 2e-4   # tests/test_sfm_distributed.py:229-236


def averaging_graph(n: int = AVG_NODES, seed: int = 3) -> tuple:
    """tests/test_sfm_distributed.py:176-200's view graph at ``n`` nodes:
    rotations exp(N(0, 1)), centres U(-5, 5)^3, a chain plus 4n random
    edges (about 5 a node), exact relative rotations and unit
    directions. Returns (n, ei, ej, R_rel, d, the true centres)."""
    from popsift_tpu_torch.sfm.rotation import exp_so3
    rng = np.random.default_rng(seed)
    R_gt = exp_so3(torch.from_numpy(
        rng.normal(0, 1, (n, 3)).astype(np.float32))).numpy()
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ei, ej = list(range(n - 1)), list(range(1, n))
    for _ in range(4 * n):
        i, j = rng.integers(0, n, 2)
        if i != j:
            ei.append(min(i, j))
            ej.append(max(i, j))
    ei, ej = np.asarray(ei, np.int64), np.asarray(ej, np.int64)
    R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei]).astype(np.float32)
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return n, ei, ej, R_rel, d, C_gt


def _timed(fn, dev, mesh=None) -> tuple:
    """(CUDA-event ms, host-wall ms) of one ``fn()`` ending in a
    synchronize; with a mesh of several ranks, all start together (a
    ``psum`` first). Host walls only on the CPU."""
    from popsift_tpu_torch.parallel.mesh import psum
    if mesh is not None:
        psum(torch.zeros(1, device=dev), mesh)
    sync(dev)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        b.record()
    sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    return (a.elapsed_time(b) if dev.type == "cuda" else wall), wall


def _turns(fns: dict, dev, reps: int, mesh=None) -> dict:
    """Each of ``fns`` timed ``reps`` times in turns (forward, then
    backward: a, b, b, a, ...) after one warm run each: {name: [median
    event ms, median wall ms]}."""
    for fn in fns.values():
        fn()
    got = {k: [] for k in fns}
    for i in range(reps):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            got[k].append(_timed(fns[k], dev, mesh))
    return {k: [round(statistics.median(t[0] for t in v), 4),
                round(statistics.median(t[1] for t in v), 4)]
            for k, v in got.items()}


def allpairs_sets(feats, rows: int = AP_ROWS) -> tuple:
    """Each frame's first ``rows`` valid descriptor rows, padded with
    invalid zero rows: (desc f32[F, rows, 128], valid bool[F, rows])."""
    F = feats.desc.shape[0]
    desc = feats.desc.new_zeros((F, rows, 128))
    valid = torch.zeros((F, rows), dtype=torch.bool, device=desc.device)
    for f in range(F):
        idx = torch.nonzero(feats.desc_valid[f])[:rows, 0]
        desc[f, :len(idx)] = feats.desc[f, idx]
        valid[f, :len(idx)] = True
    return desc, valid


def _ba_runs(mesh, fields: dict, step_fields: dict, dev, reps: int) -> dict:
    """Distributed bundle adjustment of ``fields`` (dense and CG, 10
    iterations) on this rank's shard: final cost, and with ``reps`` its
    times (ranks together); the first GN step of each kind of
    ``step_fields`` in f64, gathered in the original point order; the
    distributed runs themselves (``fn``)."""
    from popsift_tpu_torch.parallel.mesh import axis_size, psum
    from popsift_tpu_torch.sfm import ba as B
    from popsift_tpu_torch.sfm import distributed as D
    n = axis_size(mesh)
    shard = D.shard_of(D.partition_by_point(
        B.problem_from_numpy(fields, dev), n)[0], mesh)
    out = {}
    for kind, kw in (("dense", dict(dense=True)), ("cg", dict(cg_iters=25))):
        fn = D.make_distributed_ba_fn(mesh, iters=10, **kw)
        res, costs = fn(shard)
        ms = (_turns({kind: lambda: fn(shard)}, dev, reps, mesh)[kind]
              if reps else None)
        out[kind] = dict(cost=float(costs[-1]), ms=ms,
                         finite=bool(torch.isfinite(costs).all()),
                         fn=lambda fn=fn: fn(shard))
    part, idx = D.partition_by_point(B.problem_from_numpy(step_fields, dev), n)
    s64 = as_f64(D.shard_of(part, mesh))
    lam = s64.cams.new_full((), 1e-3)
    reduce = lambda x: psum(x, mesh)
    for kind, step in (("dense", lambda: B.schur_dense_step(
            s64, lam, reduce=reduce)), ("cg", lambda: B.schur_cg_step(
                s64, lam, cg_iters=25, reduce=reduce))):
        dc, dp, _ = step()
        out[f"step_{kind}"] = dict(
            dc=dc.cpu().numpy(),
            dp=D.gather_points(dp, mesh, idx).cpu().numpy())
    return out


def avg_solves(graph: tuple, dev, mesh=None) -> tuple:
    """Rotation averaging of ``graph`` and translation averaging in f32
    and f64, on one process or, with ``mesh``, with the edges sharded
    over it (``reduce=psum``): numpy (R, C, C in f64)."""
    from popsift_tpu_torch.parallel.mesh import psum
    from popsift_tpu_torch.sfm import distributed as D
    from popsift_tpu_torch.sfm import global_sfm as G
    n, ei, ej, R_rel, d = graph[:5]
    reduce = None if mesh is None else (lambda x: psum(x, mesh))
    t = lambda a: torch.from_numpy(a).to(dev)

    def edges(payload):
        if mesh is None:
            return t(ei), t(ej), t(payload), None
        return D.shard_edges(t(ei), t(ej), t(payload), None, mesh)
    ii, jj, R, v = edges(R_rel)
    out = [G.rotation_averaging(n, ii, jj, R, valid=v, reduce=reduce)[0]]
    for dd in (d, d.astype(np.float64)):
        ii, jj, dd, v = edges(dd)
        out.append(G.translation_averaging(n, ii, jj, dd, valid=v,
                                           reduce=reduce)[0])
    return tuple(x.cpu().numpy() for x in out)


def _field_gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(same shape and dtype, bit-equal, float, max |a - b|, max |b|)."""
    ok = a.shape == b.shape and a.dtype == b.dtype
    eq = ok and bool(torch.equal(a, b))
    fl = a.is_floating_point()
    diff = float((a.double() - b.double()).abs().max()) if ok and fl and \
        a.numel() else 0.0
    return ok, eq, fl, diff, float(b.abs().max()) if fl and b.numel() else 0.0


def parallel_rank(device, frames: np.ndarray, capacity: int, ref_path: str,
                  ap_desc: np.ndarray, ap_valid: np.ndarray, fields: dict,
                  step_fields: dict, graph: tuple, reps: int) -> dict:
    """Phase 12 on one rank of a job (``parallel/launch.py::spawn``):
    this rank's frames extracted and gathered, the ring and all-pairs
    matches, distributed BA and the edge-sharded averaging; the gathered
    features and ring matches compared here with the world-size-1 run
    saved at ``ref_path``. Returns comparisons, launches and times."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.parallel import batch as PB
    from popsift_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(device=device)
    me, n = M.axis_index(mesh), M.axis_size(mesh)
    b = frames.shape[0] // n
    local = torch.from_numpy(frames[me * b:(me + 1) * b]).to(device)
    cfg = SiftConfig(extrema_capacity=capacity)
    ext = PB.make_batched_extract_fn(cfg, *frames.shape[1:], mesh)
    ext(local)
    sync(device)
    kernels.reset_launch_counts()
    feats, _ = ext(local)
    sync(device)
    launches = kernels.launch_counts()
    whole = PB.gather_features(feats, mesh)
    ring = PB.gather_features(PB.ring_matches(feats, mesh), mesh)
    ref = torch.load(ref_path)
    gaps = {f"feats.{k}": _field_gap(v.cpu(), ref["feats"][k])
            for k, v in whole._asdict().items()}
    gaps.update({f"ring.{k}": _field_gap(v.cpu(), ref["ring"][k])
                 for k, v in ring._asdict().items()})
    del ref
    first = feats.desc[:1]
    times = _turns({
        "extract": lambda: ext(local),
        "gather_features": lambda: PB.gather_features(feats, mesh),
        "ring_matches": lambda: PB.ring_matches(feats, mesh),
        "ppermute_desc": lambda: M.ppermute(
            first, mesh, [(i, (i - 1) % n) for i in range(n)])}, device,
        reps, mesh)
    ap_fn = PB.make_allpairs_match_fn(mesh)
    blk = lambda a: torch.from_numpy(a[me * b:(me + 1) * b]).to(device)
    ap = PB.gather_features(ap_fn(blk(ap_desc), blk(ap_valid)), mesh)
    times.update(_turns({"allpairs": lambda: ap_fn(blk(ap_desc),
                                                    blk(ap_valid))},
                        device, reps, mesh))
    ba = _ba_runs(mesh, fields, step_fields, device, reps)
    for kind in ("dense", "cg"):
        ba[kind].pop("fn")
    return dict(rank=me, launches=launches, gaps=gaps, times=times,
                allpairs={k: v.cpu().numpy() for k, v in ap._asdict().items()},
                ba=ba, avg=avg_solves(graph, device, mesh))


def _check_gaps(tag: str, gaps: dict) -> dict:
    """Phase 5's rule on the gathered batch against the world-size-1 run:
    integer and bool fields exact, float fields bit-equal or within 1e-6
    x the field's magnitude. Returns {field: "equal" or the difference}."""
    out = {}
    for name, (ok, eq, fl, diff, mag) in gaps.items():
        check(ok, f"{tag} {name}: shape or dtype differs")
        check(eq or (fl and diff <= 1e-6 * mag),
              f"{tag} {name} differs by {diff} (magnitude {mag})")
        out[name] = "equal" if eq else f"{diff:.3g}"
    return out


def _allpairs_equal(tag: str, ap, desc, valid) -> None:
    """Every (i, j) pair of an all-pairs result equals
    ``match_descriptors`` of that pair run alone, bit for bit."""
    from popsift_tpu_torch.ops.matching import match_descriptors
    F = desc.shape[0]
    for i in range(F):
        for j in range(F):
            want = match_descriptors(desc[i], valid[i], desc[j], valid[j],
                                     tile=2048)
            for k, w in want._asdict().items():
                got = torch.as_tensor(ap[k][i, j]).to(w.device)
                check(bool(torch.equal(got, w)),
                      f"{tag}: pair ({i}, {j}) {k} differs from "
                      f"match_descriptors alone")


def parallel_phase(frames: list, dev, card: str = "", reps: int = 5,
                   expect: tuple | None = (BENCH_KEYPOINTS,
                                           BENCH_DESCRIPTORS),
                   ba_size: dict | None = None,
                   n_avg: int = AVG_NODES, ap_rows: int = AP_ROWS,
                   capacity: int = 8192) -> dict:
    """The multi-device layer on the card: (a) world size 1 on NCCL
    (``cuda:0``): ``make_batched_extract_fn(match_pairs=True)`` of the
    frames bit-equal to ``extract_batch``, the ring pairs to
    ``match_descriptors``, 0 stream syncs, the main path's launches once
    a batch; (c) all-pairs; (d) distributed BA; (e) edge-sharded
    averaging, each against its single-process run; then (b)-(e) again on
    two processes sharing the card on gloo, and (f) the dryrun at world
    size 2. Returns the times."""
    import tempfile

    import torch.distributed as dist

    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.ops.matching import match_descriptors
    from popsift_tpu_torch.parallel import batch as PB
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.launch import spawn
    from popsift_tpu_torch.pipeline import build_extract_plan, extract_batch
    from popsift_tpu_torch.sfm import ba as B
    from popsift_tpu_torch.sfm import global_sfm as G
    from popsift_tpu_torch.utils.device import init_distributed

    t_phase = time.perf_counter()
    say(f"phase 12 on {card}")
    on_card = dev.type == "cuda"
    ba_size = ba_size or dict(n_cams=BA_CAMS, n_points=BA_POINTS)
    cfg = SiftConfig(extrema_capacity=capacity)
    F, (H, W) = len(frames), frames[0].shape
    imgs = torch.from_numpy(np.stack(frames)).to(dev)
    fields, _ = ba_scene(2, noise_px=0.5, **ba_size)
    step_fields = step_scene(**ba_size)
    graph = averaging_graph(n_avg)
    times = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    init_distributed(num_processes=1, process_id=0,
                     backend="nccl" if dev.type == "cuda" else "gloo",
                     init_method=f"file://{tmp}/store")
    try:
        mesh = M.make_mesh(device=dev)
        say(f"(a) world size 1: backend {mesh.backend}, device "
            f"{mesh.device}")
        # (a) data-parallel extraction with the ring matches
        plan = build_extract_plan(cfg, H, W)
        dp_fn = PB.make_batched_extract_fn(cfg, H, W, mesh, match_pairs=True)
        ext_fn = PB.make_batched_extract_fn(cfg, H, W, mesh)
        extract_batch(imgs, plan, dev)
        sync(dev)
        kernels.reset_launch_counts()
        ref = extract_batch(imgs, plan, dev)
        sync(dev)
        want = kernels.launch_counts()
        dp_fn(imgs)
        sync(dev)
        kernels.reset_launch_counts()
        feats, ring = dp_fn(imgs)
        sync(dev)
        launches = kernels.launch_counts()
        check(launches == want, f"(a) launches {launches} against "
              f"extract_batch's {want}")
        for name in MAIN_PATH:
            check(launches[name] > 0, f"(a): {name} not launched")
        for name in FUSED_ONCE:
            check(launches[name] == 1, f"(a): {name} launched "
                  f"{launches[name]} times for the batch")
        for name, a, b in zip(feats._fields, feats, ref):
            check(bool(torch.equal(a, b)), f"(a) {name} differs from "
                  f"extract_batch")
        counts = (int(feats.n_keypoints[0]), int(feats.n_descriptors[0]))
        if expect is not None:
            check(counts == expect and not feats.octave_dropped[0].any(),
                  f"(a) frame 0 gave {counts}, expected {expect}")
        pairs = [match_descriptors(ref.desc[i], ref.desc_valid[i],
                                   ref.desc[(i + 1) % F],
                                   ref.desc_valid[(i + 1) % F], tile=2048)
                 for i in range(F)]
        for i, m in enumerate(pairs):
            for k, a, b in zip(m._fields, ring, m):
                check(bool(torch.equal(a[i], b)), f"(a) ring pair {i}: {k} "
                      f"differs from match_descriptors")
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            again = dp_fn(imgs)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        check(all(torch.equal(a, b) for a, b in zip(again[0], feats))
              and all(torch.equal(a, b) for a, b in zip(again[1], ring)),
              "(a) a second run differs")
        say(f"(a) {F} frames: features bit-equal to extract_batch, frame 0 "
            f"{counts[0]} / {counts[1]}, the {F} ring pairs bit-equal to "
            f"match_descriptors (accepted {ring.accept.sum(1).tolist()}), "
            f"0 stream syncs (sync debug mode \"error\"), launches "
            f"{launches}")
        t = _turns({"make_batched_extract_fn": lambda: ext_fn(imgs),
                    "extract_batch": lambda: extract_batch(imgs, plan, dev)},
                   dev, reps)
        times["ws1_ms_per_frame"] = {k: [round(x / F, 4) for x in v]
                                     for k, v in t.items()}
        times["ws1_ring_matches"] = _turns(
            {"ring": lambda: PB.ring_matches(feats, mesh)}, dev, reps)["ring"]
        say(f"(a) ms/frame [CUDA events, host wall], median of {reps} in "
            f"turns: {times['ws1_ms_per_frame']}; ring step ({F} pairs) "
            f"{times['ws1_ring_matches']} ms")

        # (c) all-pairs over the frames' first AP_ROWS valid descriptors
        ap_desc, ap_valid = allpairs_sets(ref, ap_rows)
        ap_fn = PB.make_allpairs_match_fn(mesh)
        ap1 = ap_fn(ap_desc, ap_valid)
        _allpairs_equal("(c) world size 1", ap1._asdict(), ap_desc, ap_valid)
        times["ws1_allpairs"] = _turns(
            {"ap": lambda: ap_fn(ap_desc, ap_valid)}, dev, reps)["ap"]
        say(f"(c) world size 1: all {F * F} pairs of {ap_rows} rows "
            f"bit-equal to match_descriptors alone; "
            f"{times['ws1_allpairs']} ms")

        # (d) distributed BA against bundle_adjust
        pd = B.problem_from_numpy(fields, dev)
        single = {"dense": lambda: B.bundle_adjust(pd, iters=10, dense=True),
                  "cg": lambda: B.bundle_adjust(pd, iters=10, dense=False,
                                                cg_iters=25)}
        ba1 = _ba_runs(mesh, fields, step_fields, dev, 0)
        ref_cost = {k: float(fn()[1][-1]) for k, fn in single.items()}
        p64 = as_f64(B.problem_from_numpy(step_fields, dev))
        lam = p64.cams.new_full((), 1e-3)
        steps = {"dense": B.schur_dense_step(p64, lam)[:2],
                 "cg": B.schur_cg_step(p64, lam, cg_iters=25)[:2]}
        for kind in ("dense", "cg"):
            _check_ba(f"(d) world size 1 {kind}", ba1[kind], ba1[f"step_{kind}"],
                      ref_cost[kind], steps[kind])
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                ba1[kind]["fn"]()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
            t = _turns({"distributed": ba1[kind]["fn"],
                        "bundle_adjust": single[kind]}, dev, reps)
            times[f"ws1_ba_{kind}"] = t
            say(f"(d) world size 1 {kind}: the LM loop ran under sync debug "
                f"mode \"error\" (0 host syncs); ms [CUDA events, host "
                f"wall], median of {reps} in turns: {t}")

        # (e) edge-sharded averaging against the single-process solve
        avg_ref = avg_solves(graph, dev)
        _check_avg("(e) world size 1", avg_solves(graph, dev, mesh),
                   avg_ref, graph)
        saved = os.path.join(tmp, "ref.pt")
        torch.save({"feats": {k: v.cpu() for k, v in feats._asdict().items()},
                    "ring": {k: v.cpu() for k, v in ring._asdict().items()}},
                   saved)
        ap_np = (ap_desc.cpu().numpy(), ap_valid.cpu().numpy())
        ap_ref = {k: v.cpu() for k, v in ap1._asdict().items()}
        del feats, ring, again, ref, ap1, pd, p64
    finally:
        dist.destroy_process_group()

    # (b)-(e) on two processes sharing the card, gloo through the host
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, 2, "gloo",
                  f"cuda:{dev.index or 0}" if on_card else "cpu",
                  args=(np.stack(frames), capacity, saved, *ap_np, fields,
                        step_fields, graph, reps), timeout=900)
    walls = {"ws2_job_s": round(time.perf_counter() - t0, 3)}
    for r in ranks:
        tag = f"(b) rank {r['rank']}"
        for name in FUSED_ONCE:
            check(r["launches"][name] == 1, f"{tag}: {name} launched "
                  f"{r['launches'][name]} times for its frames")
        res = _check_gaps(tag, r["gaps"])
        unequal = {k: v for k, v in res.items() if v != "equal"}
        say(f"{tag}: launches {r['launches']}; the gathered {F} frames and "
            f"ring pairs (1->2, 3->0 across the ranks) against world size 1: "
            f"{'bit-equal' if not unequal else unequal}")
        for k, v in r["allpairs"].items():
            check(np.array_equal(v, ap_ref[k].numpy()),
                  f"(c) world size 2: {k} differs from world size 1")
        for kind in ("dense", "cg"):
            _check_ba(f"(d) world size 2 rank {r['rank']} {kind}",
                      r["ba"][kind], r["ba"][f"step_{kind}"], ref_cost[kind],
                      steps[kind])
        _check_avg(f"(e) world size 2 rank {r['rank']}", r["avg"], avg_ref,
                   graph)
        times[f"ws2_rank{r['rank']}"] = dict(
            r["times"], ba_dense=r["ba"]["dense"]["ms"],
            ba_cg=r["ba"]["cg"]["ms"])
    say(f"(c) world size 2: all pairs equal to world size 1; (d), (e) as "
        f"above")
    say(f"(b)-(e) world size 2 ms [CUDA events, host wall], median of {reps}"
        f", both ranks together: {json.dumps({k: v for k, v in times.items() if k.startswith('ws2')})}")

    # (f) the dryrun on two ranks sharing the card
    times["dryrun"], walls["dryrun_s"] = dryrun_two_ranks(dev)
    say(f"(f) {times['dryrun']}")
    shutil.rmtree(tmp, ignore_errors=True)
    walls["phase_s"] = round(time.perf_counter() - t_phase, 3)
    times["walls_s"] = walls
    say("phase 12 times: " + json.dumps(times))
    return times


def dryrun_two_ranks(dev) -> tuple:
    """``tools/dryrun_multichip.py`` at world size 2, both ranks on the
    card (gloo): (its report line, seconds). Every item's check holds or
    it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "popsift_tpu_torch.tools.dryrun_multichip",
         "--world-size", "2", "--device",
         f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu",
         "--backend", "gloo"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip:")]
    check(proc.returncode == 0 and lines, f"dryrun failed "
          f"({proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return lines[-1], round(time.perf_counter() - t0, 3)


def _check_ba(tag: str, got: dict, step: dict, ref_cost: float,
              ref_step: tuple) -> None:
    """A distributed BA run's final cost within BA_COST_TOL of
    ``bundle_adjust``'s and its first f64 GN step within 1e-9 x the
    step's max of the single-process f64 step."""
    gap = abs(got["cost"] - ref_cost) / ref_cost
    f64 = {k: _gap(torch.from_numpy(step[k]), r)
           for k, r in zip(("dc", "dp"), ref_step)}
    say(f"{tag}: final cost {got['cost']:.8g} against bundle_adjust's "
        f"{ref_cost:.8g} ({gap:.3g} relative); first f64 step dc "
        f"{f64['dc']:.3g}, dp {f64['dp']:.3g} x its max off the "
        f"single-process step")
    check(got["finite"] and gap <= BA_COST_TOL,
          f"{tag}: final cost {gap} off bundle_adjust's")
    check(all(v <= 1e-9 for v in f64.values()), f"{tag}: f64 step {f64}")


def _check_avg(tag: str, got: tuple, ref: tuple, graph: tuple) -> None:
    """The edge-sharded solves ``got`` (R, C, C in f64) against the
    single-process ``ref``: rotations within ROTATION_TOL, the f64
    translations within phase 10's TRANSLATION_F32_TOL x the scale. The
    f32 translations are read, not held: at this size the dense f32
    solve (its gauge pinned by a 1e6 diagonal) moves with the last bits
    of its system, and its annealed IRLS carries that anywhere (ROADMAP
    C); their gaps and ATEs are printed."""
    from popsift_tpu_torch.sfm.evaluate import umeyama
    C_gt = graph[5].astype(np.float64)

    def ate(C):
        s, R, t = umeyama(C.astype(np.float64), C_gt)
        return float(np.linalg.norm(C @ (s * R).T + t - C_gt, axis=1).max())

    scale = float(np.linalg.norm(ref[2] - ref[2].mean(0), axis=1).mean())
    gap = lambda a, b: float(np.linalg.norm(a - b, axis=1).max()) / scale
    r_gap = float(np.abs(got[0] - ref[0]).max())
    t64, t32 = gap(got[2], ref[2]), gap(got[1], ref[1])
    say(f"{tag}: averaging of {graph[0]} nodes / {len(graph[1])} edges: "
        f"rotations {r_gap:.3g} off the single-process solve; translations "
        f"in f64 {t64:.3g} x the scale off it; in f32 {t32:.3g} (the "
        f"single-process f32 solve {gap(ref[1], ref[2]):.3g} off the f64 "
        f"one; largest error after a similarity: f32 {ate(got[1]):.3g}, "
        f"single-process f32 {ate(ref[1]):.3g}, f64 {ate(got[2]):.3g})")
    check(r_gap <= ROTATION_TOL, f"{tag}: rotations {r_gap} off")
    check(t64 <= TRANSLATION_F32_TOL, f"{tag}: f64 translations {t64} x "
          f"the scale off")


# phase 13: the spatially sharded extraction (parallel/spatial.py)
BOUNDED = ("refine_octaves_bounded", "orientation_hist_octaves_bounded",
           "descriptor_loop_octaves_bounded")
SPATIAL_PATH = ("blur_dog", "blur_dog_thin", "extrema_mask_octaves",
                "compact") + BOUNDED
FRAME_4K = (2160, 3840)
# per-octave capacity of the 4K runs: the densest 4K octave holds about
# four times the 1080p frame's 2005 candidates, and a band takes half
CAPACITY_4K = 32768


def _spatial_fields(feats) -> dict:
    return {k: v.cpu() for k, v in feats._asdict().items()}


def canonical(f: dict) -> dict:
    """One frame's features (CPU tensors) in an order that does not depend
    on how the ranks laid their rows out: the valid keypoints sorted by
    (octave, x, y, sigma) with their orientations, then the valid
    descriptors in that keypoint order (a keypoint's in job order), and
    the counts. A sharded octave's rows are its bands' rows, each band
    front-packed, so two world sizes order them differently."""
    rows = f["valid"].nonzero()[:, 0].numpy()
    key = [f[k].numpy()[rows] for k in ("sigma", "y", "x", "octave")]
    order = rows[np.lexsort(key)]
    rank = np.full(f["valid"].shape[0], -1)
    rank[order] = np.arange(order.size)
    drows = f["desc_valid"].nonzero()[:, 0].numpy()
    dorder = drows[np.lexsort((drows, rank[f["desc_kp"].numpy()[drows]]))]
    out = {k: f[k][torch.from_numpy(order)] for k in
           ("x", "y", "sigma", "octave", "num_ori", "ori", "ori_valid")}
    out["desc"] = f["desc"][torch.from_numpy(dorder)]
    for k in ("n_keypoints", "n_descriptors", "octave_candidates",
              "octave_dropped"):
        out[k] = f[k]
    return out


def _gaps(got, ref: dict, layout: bool = True) -> dict:
    """Field gaps (:func:`_field_gap`) of features ``got`` to the CPU
    fields ``ref``: row for row, or with ``layout=False`` of their
    :func:`canonical` forms."""
    got = _spatial_fields(got)
    if not layout:
        got, ref = canonical(got), canonical(ref)
    return {k: _field_gap(v, ref[k]) for k, v in got.items()}


def _memory_peak(fn, dev) -> int:
    """Bytes ``fn()`` takes on the card at its peak."""
    if dev.type != "cuda":
        return 0
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    sync(dev)
    return torch.cuda.max_memory_allocated(dev)


def _capture_bounded():
    """Wrap the three bounded entries where the ops modules call them;
    returns (captured {K2, K3, K4: (args, kwargs)} of each last bounded
    call, restore)."""
    from popsift_tpu_torch.ops import descriptors, extrema, orientation
    sites = [(extrema, "refine_state_octaves", "K2"),
             (orientation, "orientation_hist_octaves", "K3"),
             (descriptors, "descriptor_loop_octaves", "K4")]
    captured, saved = {}, []
    for mod, name, tag in sites:
        real = getattr(mod, name)
        saved.append((mod, name, real))

        def wrap(*a, _real=real, _tag=tag, **k):
            captured[_tag] = (a, k)
            return _real(*a, **k)
        setattr(mod, name, wrap)

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return captured, restore


def bounded_kernels(captured: dict, dev, reps: int) -> list:
    """(e): the bounded launches of K2, K3 and K4 that one sharded
    extraction made on a band, again, against their plain versions on the
    same tensors (K2 bit-equal, K3 and K4 within 1e-5 x the row's max)
    and, with the default bounds on the same stacks, bit-equal to the
    unbounded launch; median times and bounds. Returns the JSON rows."""
    from popsift_tpu_torch.ops.kernels import ENTRIES, desc, orient, refine
    rows = []

    def add(name, err, ms, plain_ms, bound):
        mod, _, replaces = ENTRIES[name]
        rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": None})
        say(f"(e) {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library call none, bound {bound[0]:.4f} ms "
            f"(by {bound[1]})")

    a, k = captured["K2"]
    got = refine.refine_state_octaves(*a, **k)
    check(bool(torch.equal(got, refine.refine_state_octaves_torch(*a, **k))),
          "(e) bounded K2 differs from its plain version")
    plain = {kk: v for kk, v in k.items() if kk not in ("y_offsets",
                                                         "heights")}
    dflt = dict(plain, y_offsets=[0] * len(a[0]),
                heights=[d.shape[1] for d in a[0]])
    check(bool(torch.equal(refine.refine_state_octaves(*a, **dflt),
                           refine.refine_state_octaves(*a, **plain))),
          "(e) K2 with whole-stack bounds differs from the unbounded launch")
    live = int(a[4].sum())
    add("refine_octaves_bounded", 0.0,
        median_ms(lambda: refine.refine_state_octaves(*a, **k), dev, reps),
        median_ms(lambda: refine.refine_state_octaves_torch(*a, **k), dev,
                  reps), refine_bound(live, a[1].shape[0]))

    def held(tag, fn, fn_torch, bound):
        a, k = captured[tag]
        got = fn(*a, **k)
        ref = fn_torch(*a, **k)
        rel = rel_row_err(got, ref)
        check(rel <= 1e-5, f"(e) bounded {tag} differs from its plain "
              f"version by {rel} x row max")
        plain = {kk: v for kk, v in k.items() if kk not in ("y_offsets",
                                                             "y_bounds")}
        dflt = dict(plain, y_offsets=[0] * len(a[0]),
                    y_bounds=[(1, b.shape[1] - 2) for b in a[0]])
        check(bool(torch.equal(fn(*a, **dflt), fn(*a, **plain))),
              f"(e) {tag} with whole-stack bounds differs from the "
              f"unbounded launch")
        add(f"{fn.__name__}_bounded", float((got - ref).abs().max()),
            median_ms(lambda: fn(*a, **k), dev, reps),
            median_ms(lambda: fn_torch(*a, **k), dev, reps), bound)

    a3 = captured["K3"][0]
    held("K3", orient.orientation_hist_octaves,
         orient.orientation_hist_octaves_torch,
         ori_bound(a3[4][a3[6]], a3[2].shape[0]))
    a4 = captured["K4"][0]
    held("K4", desc.descriptor_loop_octaves,
         desc.descriptor_loop_octaves_torch,
         desc_bound(a4[4][a4[7]], a4[8], a4[2].shape[0]))
    return rows


def spatial_rank(device, frames: np.ndarray, frame4k: np.ndarray,
                 capacity: int, capacity_4k: int, tmp: str,
                 reps: int) -> dict:
    """Phase 13 (b), (d) and (e) on one rank of a job whose ranks split
    the rows (``parallel/launch.py::spawn``): frames 0 and 1 and the 4K
    frame through ``make_sharded_extract_fn``, each against world size
    1's result saved in ``tmp``; launches, traffic, band counts, peak
    memory and times in turns with single-device ``extract``; on the
    last rank also (e) on its band's bounded launches."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.spatial import make_sharded_extract_fn
    from popsift_tpu_torch.pipeline import build_extract_plan, extract
    mesh = M.make_mesh(device=device, axis_name="sp")
    me, n = M.axis_index(mesh), M.axis_size(mesh)
    ref = torch.load(os.path.join(tmp, "ws1.pt"))
    out = dict(rank=me)
    for tag, imgs, cap in (("1080p", frames, capacity),
                           ("4k", frame4k[None], capacity_4k)):
        H, W = imgs.shape[1:]
        hs = H // n
        cfg = SiftConfig(extrema_capacity=cap)
        fn, eff = make_sharded_extract_fn(cfg, H, W, mesh)
        plan = build_extract_plan(cfg, H, W, octave_caps=eff)
        full = torch.from_numpy(imgs[0]).to(device)
        bands = [torch.from_numpy(f[me * hs:(me + 1) * hs]).to(device)
                 for f in imgs]
        fn(bands[0])
        sync(device)
        kernels.reset_launch_counts()
        fn.traffic.clear()
        got = [fn(b) for b in bands[:1]]
        sync(device)
        r = dict(launches=kernels.launch_counts(), traffic=dict(fn.traffic),
                 S=fn.layout.S, bands=fn.layout.band,
                 band_counts=fn.band_counts.tolist())
        got += [fn(b) for b in bands[1:]]
        r["gaps"] = [_gaps(g, ref[f"{tag}_{i}"], layout=False)
                     for i, g in enumerate(got)]
        if me == 0 and tag == "1080p":
            torch.save({f"f{i}": _spatial_fields(g) for i, g in
                        enumerate(got)}, os.path.join(tmp, "ws2.pt"))
        del got
        r["peak_bytes"] = {
            "sharded": _memory_peak(lambda: fn(bands[0]), device),
            "extract": _memory_peak(lambda: extract(full, plan, device),
                                    device)}
        r["ms"] = _turns({"sharded": lambda: fn(bands[0]),
                          "extract": lambda: extract(full, plan, device)},
                         device, reps, mesh)
        if tag == "1080p":
            # every rank runs the call (its collectives need them all)
            captured, restore = _capture_bounded()
            try:
                fn(bands[0])
            finally:
                restore()
            if me == n - 1:
                r["bounded_rows"] = bounded_kernels(captured, device, reps)
            del captured
        out[tag] = r
        del fn, plan, full, bands
        if device.type == "cuda":
            torch.cuda.empty_cache()
    M.psum(torch.zeros(1, device=device), mesh)   # every rank done
    return out


def spatial_dpsp_rank(device, frames: np.ndarray, capacity: int,
                      tmp: str) -> dict:
    """Phase 13 (c) on one rank of a (2, 2) mesh: the two frames, one a
    "dp" group, each row-sharded over its "sp" pair
    (``make_batched_sharded_extract_fn``), gathered over "dp"; the gaps
    to the world-size-2 results in ``tmp`` (the same row layout) and the
    launches."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.batch import gather_features
    from popsift_tpu_torch.parallel.spatial import (
        make_batched_sharded_extract_fn)
    m2 = M.make_mesh_2d(2, 2, names=("dp", "sp"), device=device)
    i, j = m2.coords["dp"], m2.coords["sp"]
    H, W = frames.shape[1:]
    fn, _ = make_batched_sharded_extract_fn(SiftConfig(
        extrema_capacity=capacity), H, W, m2)
    band = torch.from_numpy(frames[i:i + 1, j * H // 2:(j + 1) * H // 2]
                            ).to(device)
    fn(band)
    sync(device)
    kernels.reset_launch_counts()
    feats = fn(band)
    sync(device)
    launches = kernels.launch_counts()
    whole = gather_features(feats, m2, "dp")
    ref = torch.load(os.path.join(tmp, "ws2.pt"))
    gaps = [{k: _field_gap(v[f].cpu(), ref[f"f{f}"][k])
             for k, v in whole._asdict().items()} for f in range(2)]
    return dict(coords=(i, j), launches=launches, gaps=gaps)


def _mb(n_bytes: int) -> float:
    return round(n_bytes / 2 ** 20, 1)


def spatial_phase(frames: list, dev, card: str = "", reps: int = 5,
                  expect: tuple | None = (BENCH_KEYPOINTS,
                                          BENCH_DESCRIPTORS),
                  capacity: int = 8192, frame4k: np.ndarray | None = None,
                  capacity_4k: int = CAPACITY_4K,
                  dryrun: str | None = None) -> dict:
    """The spatially sharded extraction on the card: (a) world size 1 on
    NCCL, frame 0 through ``make_sharded_extract_fn`` equal in every field
    to ``extract`` at the effective capacities, the sharded path's
    kernels launched (K2, K3 and K4 through their bounded entries, once),
    0 stream syncs, ms/frame in turns with ``extract``; the 4K frame the
    same way with peak memory; (b) and (d) world size 2 on gloo with both
    ranks on the card, frames 0-1 and the 4K frame against (a) by phase
    5's rule, bands, candidates, traffic, peak memory and times a rank;
    (c) DP x SP on a (2, 2) mesh of four ranks on the card, frames 0-1
    against (b); (e) the bounded kernels of a band against their plain
    versions; (f) the dryrun at world size 2 (its report line ``dryrun``
    where phase 12 ran it already: its items 2 and 2b are the spatial
    path's). Returns the times and the JSON rows of the bounded entries
    (their launches from (a))."""
    import tempfile

    import torch.distributed as dist

    import bench
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.launch import spawn
    from popsift_tpu_torch.parallel.spatial import make_sharded_extract_fn
    from popsift_tpu_torch.pipeline import build_extract_plan, extract
    from popsift_tpu_torch.utils.device import init_distributed

    t_phase = time.perf_counter()
    say(f"phase 13 on {card}")
    on_card = dev.type == "cuda"
    if frame4k is None:
        frame4k = bench.make_frame(*FRAME_4K)
    two = np.stack(frames[:2])
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    init_distributed(num_processes=1, process_id=0,
                     backend="nccl" if on_card else "gloo",
                     init_method=f"file://{tmp}/store")
    try:
        mesh = M.make_mesh(device=dev, axis_name="sp")
        refs = {}
        for tag, imgs, cap in (("1080p", two, capacity),
                               ("4k", frame4k[None], capacity_4k)):
            H, W = imgs.shape[1:]
            cfg = SiftConfig(extrema_capacity=cap)
            fn, eff = make_sharded_extract_fn(cfg, H, W, mesh)
            plan = build_extract_plan(cfg, H, W, octave_caps=eff)
            x = [torch.from_numpy(f).to(dev) for f in imgs]
            fn(x[0])
            sync(dev)
            kernels.reset_launch_counts()
            feats = fn(x[0])
            sync(dev)
            launches = kernels.launch_counts()
            same = []
            for i, f in enumerate(x):
                got = feats if i == 0 else fn(f)
                want = extract(f, plan, dev)
                res = _check_gaps(f"(a) {tag} frame {i} against extract",
                                  _gaps(got, _spatial_fields(want)))
                same.append({k: v for k, v in res.items() if v != "equal"}
                            or "bit-equal")
                refs[f"{tag}_{i}"] = _spatial_fields(got)
            cand = want.octave_candidates.tolist()
            dropped = feats.octave_dropped.tolist()
            check(all(c < e for c, e in zip(cand, eff)) and not any(dropped),
                  f"(a) {tag}: an octave saturated or dropped (candidates "
                  f"{cand}, capacities {list(eff)}, dropped {dropped})")
            counts = (int(feats.n_keypoints), int(feats.n_descriptors))
            for name in SPATIAL_PATH:
                check(launches[name] > 0, f"(a) {tag}: {name} not launched")
            for name in BOUNDED + ("extrema_mask_octaves", "compact"):
                check(launches[name] == 1, f"(a) {tag}: {name} launched "
                      f"{launches[name]} times")
            for name in ("refine_octaves", "orientation_hist_octaves",
                         "descriptor_loop_octaves"):
                check(launches[name] == 0, f"(a) {tag}: the unbounded "
                      f"{name} launched")
            if tag == "1080p":
                out["launches"] = launches
                if expect is not None:
                    check(counts == expect, f"(a) frame 0 gave {counts}, "
                          f"expected {expect}")
                if on_card:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    again = fn(x[0])
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
                check(all(torch.equal(a, b) for a, b in zip(again, feats)),
                      "(a) a second run differs")
                del again
            peaks = {"sharded": _memory_peak(lambda: fn(x[0]), dev),
                     "extract": _memory_peak(lambda: extract(x[0], plan, dev),
                                             dev)}
            t = _turns({"sharded": lambda: fn(x[0]),
                        "extract": lambda: extract(x[0], plan, dev)},
                       dev, reps)
            out[f"ws1_{tag}"] = dict(ms=t, peak_mb={k: _mb(v) for k, v in
                                                    peaks.items()})
            say(f"(a) world size 1 ({mesh.backend}), {tag} {H} x {W}: S = "
                f"{fn.layout.S} sharded octaves; against extract at the "
                f"effective capacities {list(eff)}, field for field: "
                f"{same}; frame 0 {counts[0]} / "
                f"{counts[1]}, octave_dropped {dropped}, candidates "
                f"{cand}; launches {launches}"
                + ("; 0 stream syncs (sync debug mode \"error\")"
                   if tag == "1080p" and on_card else "")
                + f"; peak MB {out[f'ws1_{tag}']['peak_mb']}; ms/frame "
                f"[CUDA events, host wall], median of {reps} in turns: {t}")
            del fn, plan, x, feats, want, got
            if on_card:
                torch.cuda.empty_cache()
        torch.save(refs, os.path.join(tmp, "ws1.pt"))
        del refs
    finally:
        dist.destroy_process_group()

    # (b), (d), (e): two ranks sharing the card, gloo through the host
    share = f"cuda:{dev.index or 0}" if on_card else "cpu"
    t0 = time.perf_counter()
    ranks = spawn(spatial_rank, 2, "gloo", share,
                  args=(two, frame4k, capacity, capacity_4k, tmp, reps),
                  timeout=900)
    walls = {"ws2_job_s": round(time.perf_counter() - t0, 3)}
    rows = []
    for r in ranks:
        for tag in ("1080p", "4k"):
            d = r[tag]
            name = f"(b) rank {r['rank']} {tag}" if tag == "1080p" else \
                f"(d) rank {r['rank']} 4K"
            for name_ in ("extrema_mask_octaves", "compact") + BOUNDED:
                check(d["launches"][name_] == 1, f"{name}: {name_} launched "
                      f"{d['launches'][name_]} times")
            res = [_check_gaps(f"{name} frame {i}", g)
                   for i, g in enumerate(d["gaps"])]
            unequal = [{k: v for k, v in x.items() if v != "equal"}
                       for x in res]
            syncs = sum(d["traffic"].get(k, 0) for k in
                        ("exchange", "gather", "psum"))
            peak = {k: _mb(v) for k, v in d["peak_bytes"].items()}
            out[f"ws2_rank{r['rank']}_{tag}"] = dict(
                ms=d["ms"], peak_mb=peak, traffic=d["traffic"])
            say(f"{name}: S = {d['S']} sharded octaves, bands {d['bands']} "
                f"rows; this band's candidates {d['band_counts'][0]} and "
                f"drops {d['band_counts'][1]} per octave; against world "
                f"size 1 (both in canonical order): "
                f"{'bit-equal' if not any(unequal) else unequal}; launches "
                f"{ {k: v for k, v in d['launches'].items() if v} }; "
                f"traffic a frame {d['traffic']} ({syncs} host-staged "
                f"collectives, each a stream sync); peak MB {peak}; "
                f"ms/frame [CUDA events, host wall], median of {reps} in "
                f"turns: {d['ms']}")
        rows += r["1080p"].get("bounded_rows", [])

    # (c) DP x SP, a (2, 2) mesh of four ranks on the card
    t0 = time.perf_counter()
    quads = spawn(spatial_dpsp_rank, 4, "gloo", share,
                  args=(two, capacity, tmp), timeout=600)
    walls["dpsp_job_s"] = round(time.perf_counter() - t0, 3)
    for q in quads:
        tag = f"(c) rank at {q['coords']}"
        for name in BOUNDED:
            check(q["launches"][name] == 1, f"{tag}: {name} launched "
                  f"{q['launches'][name]} times")
        res = [_check_gaps(f"{tag} frame {f}", g)
               for f, g in enumerate(q["gaps"])]
        unequal = [{k: v for k, v in x.items() if v != "equal"} for x in res]
        say(f"{tag}: frames 0-1 against their world-size-2 results: "
            f"{'bit-equal' if not any(unequal) else unequal}")

    # (f) the dryrun on two ranks sharing the card
    if dryrun is None:
        dryrun, walls["dryrun_s"] = dryrun_two_ranks(dev)
    check("spatial pyramid" in dryrun and "(equal to extract=True)"
          in dryrun, f"(f) the dryrun's spatial items: {dryrun}")
    say(f"(f) {dryrun}")
    shutil.rmtree(tmp, ignore_errors=True)
    walls["phase_s"] = round(time.perf_counter() - t_phase, 3)
    out["walls_s"] = walls
    say("phase 13 times: " + json.dumps({k: v for k, v in out.items()
                                         if k != "launches"}))
    check(len(rows) == len(BOUNDED), "(e) did not run")
    out["rows"] = rows
    return out


# phase 14 (b): scenes outside the five goldens, chosen before any run on
# the card: name -> ((h, w, seed) of synthetic_image, SiftConfig keywords,
# the oracle's descriptor variant)
ORACLE_SCENES = {
    "scene240_seed11_default": ((240, 320, 11), dict(octaves=5), "loop"),
    "scene240_seed5_default": ((240, 320, 5), dict(octaves=5), "loop"),
    "scene240_seed11_vlfeat_igrid": ((240, 320, 11), dict(
        octaves=5, sift_mode="vlfeat", desc_mode="igrid",
        norm_mode="classic"), "igrid")}
ORACLE_WORKERS = 4     # host processes running the oracle in phase 14


def oracle_flatten(feats) -> dict:
    """scripts/make_golden.py::flatten: the oracle's features sorted by
    (x, y, sigma), as the golden fixtures store them."""
    feats = sorted(feats, key=lambda f: (round(f.x, 4), round(f.y, 4),
                                         round(f.sigma, 4)))
    x = np.array([f.x for f in feats], np.float32)
    y = np.array([f.y for f in feats], np.float32)
    sigma = np.array([f.sigma for f in feats], np.float32)
    num_ori = np.array([len(f.orientations) for f in feats], np.int32)
    ori = np.concatenate([np.asarray(f.orientations, np.float32)
                          for f in feats]) if feats else np.zeros(0)
    desc = np.concatenate([np.stack(f.descriptors).astype(np.float32)
                           for f in feats]) if feats else np.zeros((0, 128))
    return dict(x=x, y=y, sigma=sigma, num_ori=num_ori, ori=ori, desc=desc)


def match_to_oracle(tag: str, host, feats) -> dict:
    """tests/test_pipeline.py:15-38's rule for the port's ``FeaturesHost``
    against the oracle's features: equal counts, a greedy 1-1 match of
    each keypoint to the nearest unused oracle keypoint within
    |dx| + |dy| < 5e-3 px, sigma within 1e-3, equal orientation counts and
    each descriptor within ``GOLDEN_TOL["desc"]``. Returns the counts
    and the worst errors."""
    check(host.getFeatureCount() == len(feats),
          f"{tag}: {host.getFeatureCount()} keypoints vs the oracle's "
          f"{len(feats)}")
    used = [False] * len(feats)
    worst = dict(pos=0.0, sigma=0.0, desc=0.0)
    for g in host.features():
        best, bi = None, -1
        for i, o in enumerate(feats):
            d = abs(g.x - o.x) + abs(g.y - o.y)
            if not used[i] and (best is None or d < best):
                best, bi = d, i
        check(best is not None and best < GOLDEN_TOL["x"],
              f"{tag}: keypoint ({g.x}, {g.y}) unmatched (nearest {best})")
        used[bi] = True
        o = feats[bi]
        ds = abs(g.sigma - o.sigma)
        check(ds < GOLDEN_TOL["sigma"], f"{tag}: sigma off by {ds}")
        check(g.num_ori == len(o.orientations), f"{tag}: num_ori "
              f"{g.num_ori} vs the oracle's {len(o.orientations)}")
        dd = max((float(np.abs(g.descriptors[j] - o.descriptors[j]).max())
                  for j in range(g.num_ori)), default=0.0)
        check(dd < GOLDEN_TOL["desc"], f"{tag}: descriptor off by {dd}")
        worst = dict(pos=max(worst["pos"], best),
                     sigma=max(worst["sigma"], ds),
                     desc=max(worst["desc"], dd))
    return dict(keypoints=len(feats),
                descriptors=sum(len(o.orientations) for o in feats),
                worst=worst)


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


def chain_against_extract(chain: list, feats, plan) -> dict:
    """Each octave's rows of the per-octave chain against ``extract``'s
    rows of that octave: the keypoint masks, x, y and sigma (scaled to the
    input image), the orientation masks and the job masks exact, the
    angles and the descriptors within ``GOLDEN_TOL`` (the card runs the
    same kernel bodies, so they are expected bit-equal; the CPU's plain
    versions round exp and atan2 by where a row lies in the batch, and
    the peak fit turns a 1-ULP histogram change into up to 5e-5 rad);
    returns the totals and the largest differences."""
    ko = np.concatenate([[0], np.cumsum(plan.ext_caps)]).astype(int)
    jo = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)
    up = plan.config.upscale_factor
    n_kp = n_desc = 0
    ori_err = desc_err = 0.0
    for o, (ext, oris, jobs, desc) in enumerate(chain):
        k, j = slice(ko[o], ko[o + 1]), slice(jo[o], jo[o + 1])
        scale = 2.0 ** (o - up)
        for name, a, b in (
                ("valid", ext.valid, feats.valid[k]),
                ("x", ext.x * scale, feats.x[k]),
                ("y", ext.y * scale, feats.y[k]),
                ("sigma", ext.sigma * scale, feats.sigma[k]),
                ("ori_valid", oris.ori_valid, feats.ori_valid[k]),
                ("num_ori", oris.num_ori, feats.num_ori[k]),
                ("desc_valid", jobs.valid, feats.desc_valid[j])):
            check(torch.equal(a, b), f"(c) octave {o}: {name} differs from "
                  f"extract's")
        ori_err = max(ori_err, float((oris.ori - feats.ori[k]).abs().max()))
        n = int(jobs.count)
        if n:
            desc_err = max(desc_err, float((desc[:n] - feats.desc[j][:n])
                                           .abs().max()))
        n_kp += int((ext.valid & (oris.num_ori > 0)).sum())
        n_desc += n
    check(ori_err < GOLDEN_TOL["ori"], f"(c) orientations off extract's by "
          f"{ori_err}")
    check(desc_err < GOLDEN_TOL["desc"], f"(c) descriptors off extract's "
          f"by {desc_err}")
    return dict(keypoints=n_kp, descriptors=n_desc, ori_max_abs_err=ori_err,
                desc_max_abs_err=desc_err)


def oracle_phase(frame: np.ndarray, dev, reps: int = 5,
                 expect: tuple | None = (BENCH_KEYPOINTS,
                                         BENCH_DESCRIPTORS),
                 capacity: int = 8192) -> dict:
    """Phase 14: the port's copy of the NumPy oracle and the per-octave
    public names. (a) the copy's ``oracle_extract`` on the five golden
    cases against tests/golden, each field's max difference printed and
    held within ``GOLDEN_TOL``; (b) the port on the card against the
    copy on ``ORACLE_SCENES`` by tests/test_pipeline.py's rule
    (:func:`match_to_oracle`); (c) the per-octave chain on ``frame`` at
    ``SiftConfig(extrema_capacity=capacity)``, every launch counter reset
    just before it, against ``extract``'s rows (``expect``: its keypoint
    and descriptor totals), ``make_extract_fn`` equal to ``extract``, and
    both timed in turns. The oracle runs in ``ORACLE_WORKERS`` host
    processes while the card runs (c). Returns (c)'s launches."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import kernels
    from popsift_tpu_torch.oracle import oracle_extract
    from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                            make_extract_fn)
    t_phase = time.perf_counter()
    fixtures = golden_cases()
    cases = dict(fixtures)
    for name, ((h, w, seed), kw, variant) in ORACLE_SCENES.items():
        cases[name] = (synthetic_image(h, w, seed=seed), SiftConfig(**kw),
                       variant)
    with ProcessPoolExecutor(
            ORACLE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        # the largest scenes first
        jobs = {name: pool.submit(oracle_extract, img, cfg,
                                  desc_variant=variant)
                for name, (img, cfg, variant) in sorted(
                    cases.items(), key=lambda c: -c[1][0].size)}

        # (c) on the card meanwhile
        cfg = SiftConfig(extrema_capacity=capacity)
        plan = build_extract_plan(cfg, *frame.shape)
        uploaded = torch.from_numpy(frame).to(dev)
        feats = extract(uploaded, plan, dev)
        per_octave_chain(uploaded, plan)      # warm: the cached constants
        sync(dev)
        kernels.reset_launch_counts()
        chain = per_octave_chain(uploaded, plan)
        sync(dev)
        launches = kernels.launch_counts()
        n_oct = len(plan.ext_caps)
        with_jobs = sum(int(c[2].count) > 0 for c in chain)
        want = dict(extrema_mask=n_oct, compact=n_oct, refine_octaves=n_oct,
                    orientation_hist=n_oct, descriptor_loop=with_jobs,
                    extrema_mask_octaves=0, refine=0,
                    orientation_hist_octaves=0, descriptor_loop_octaves=0)
        if dev.type == "cuda":
            for name, n in want.items():
                check(launches[name] == n, f"(c) {name} launched "
                      f"{launches[name]} times, expected {n}")
            check(launches["blur_dog"] > 0, "(c) K5 was not launched")
        got = chain_against_extract(chain, feats, plan)
        if expect is not None:
            check((got["keypoints"], got["descriptors"]) == tuple(expect),
                  f"(c) {got['keypoints']} / {got['descriptors']}, "
                  f"expected {expect}")
        fn = make_extract_fn(plan, dev)
        for name, a, b in zip(feats._fields, fn(uploaded), feats):
            check(torch.equal(a, b), f"(c) make_extract_fn: {name} differs "
                  f"from extract's")
        say(f"(c) per-octave chain on {frame.shape[0]} x {frame.shape[1]}, "
            f"{n_oct} octaves: {got['keypoints']} / {got['descriptors']}; "
            f"against extract's rows of each octave: keypoints exact, "
            f"orientations within {got['ori_max_abs_err']:.3g} rad, "
            f"descriptors within {got['desc_max_abs_err']:.3g}"
            f"; make_extract_fn equal to extract in every field; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        t_wait = time.perf_counter()
        oracle = {name: job.result() for name, job in jobs.items()}
        oracle_wait_s = time.perf_counter() - t_wait

    # (a) the copy against the fixtures
    for name in fixtures:
        fixture = np.load(os.path.join(REPO, "tests", "golden",
                                       f"{name}.npz"))
        flat = oracle_flatten(oracle[name])
        check(len(flat["x"]) == len(fixture["x"])
              and np.array_equal(flat["num_ori"], fixture["num_ori"]),
              f"(a) {name}: {len(flat['x'])} keypoints vs the fixture's "
              f"{len(fixture['x'])}, or orientation counts differ")
        errs = {k: float(np.max(np.abs(flat[k] - fixture[k]), initial=0.0))
                for k in GOLDEN_TOL}
        for k, tol in GOLDEN_TOL.items():
            check(errs[k] < tol, f"(a) {name}: {k} off the fixture by "
                  f"{errs[k]}")
        say(f"(a) oracle copy, {name}: {len(flat['x'])} keypoints, "
            f"{len(flat['desc'])} descriptors, max difference from the "
            f"fixture {errs}")

    # (b) the port on the card against the copy
    out = {}
    for name in ORACLE_SCENES:
        img, cfg, _ = cases[name]
        host = PopSift(cfg, device=dev).enqueue(img).get()
        out[name] = match_to_oracle(f"(b) {name}", host, oracle[name])
        say(f"(b) {name} ({img.shape[0]} x {img.shape[1]}, "
            f"{cfg.sift_mode}, {cfg.desc_mode}): the port on {dev.type} "
            f"against the oracle copy: {out[name]['keypoints']} / "
            f"{out[name]['descriptors']} on both, worst {out[name]['worst']}")

    # (c)'s times, after the oracle's processes ended
    def run(f):
        f()
        sync(dev)

    paths = {"extract": lambda: extract(uploaded, plan, dev),
             "chain": lambda: per_octave_chain(uploaded, plan)}
    times = {k: [] for k in paths}
    for i in range(reps):
        for k in (("extract", "chain") if i % 2 == 0
                  else ("chain", "extract")):
            t0 = time.perf_counter()
            run(paths[k])
            times[k].append((time.perf_counter() - t0) * 1e3)
    ms = {k: round(statistics.median(v), 3) for k, v in times.items()}
    say(f"(c) ms/frame (warm median of {reps} in turns, host clock, ends in "
        f"synchronize): {ms}; oracle wait {oracle_wait_s:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def profile_phase(frame: np.ndarray, dev, out_dir: str) -> None:
    """A torch.profiler table of one run of the main path, of the window
    route and of the chain front, written to DIR/profile*.txt."""
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.pipeline import build_extract_plan, extract
    plan = build_extract_plan(SiftConfig(extrema_capacity=8192),
                              *frame.shape)
    os.makedirs(out_dir, exist_ok=True)
    routes = {"profile": {}, "profile_windows": dict(detect="windows"),
              "profile_chain": dict(front="chain")}
    for name, route in routes.items():
        extract(frame, plan, dev, **route)
        sync(dev)
        path = os.path.join(out_dir, f"{name}.txt")
        counts = profile_counts(lambda: extract(frame, plan, dev, **route),
                                dev, table=path)
        say(f"{name} {route}: {counts}; table in {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also write a torch.profiler table of one "
                         "main-path run to DIR/profile.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import bench   # numpy-only frame generator, shared with the JAX bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    say("phase 1: card")
    card = card_phase(dev)
    say("phase 2: build")
    build_phase()
    say("phase 3: kernels against their plain versions at 1080p shapes")
    frames = [bench.make_frame(*FRAME_HW, seed=s) for s in range(N_FRAMES)]
    rows = kernels_phase(frames, dev)
    say("phase 4: main path")
    golden_phase(dev)
    launches = main_path_phase(frames[0], dev)
    if args.profile:
        profile_phase(frames[0], dev, args.profile)
    say("phase 5: batch path and calibration")
    runs = {"main": launches, "batch": batch_phase(frames, dev)}
    say("phase 6: window route, chain front and the entries off every path")
    runs.update(routes_phase(frames, dev))
    say("phase 7: match path")
    match_phase(frames, dev, launches)
    say("phase 8: variants")
    variants_phase(frames, dev)
    say("phase 9: SfM geometry (bundle adjustment, PnP)")
    sfm_phase(dev, table_dir=args.profile)
    say("phase 10: SfM drivers (incremental, global)")
    drivers_phase(dev)
    say("phase 11: popsift-sfm, images to model")
    sfm_cli_phase(dev)
    say("phase 12: multi-device layer (world sizes 1 and 2)")
    p12 = parallel_phase(frames, dev, card["nvidia_smi"])
    say("phase 13: spatially sharded extraction (world sizes 1, 2, 2 x 2)")
    spatial = spatial_phase(frames, dev, card["nvidia_smi"],
                            dryrun=p12["dryrun"])
    rows += spatial["rows"]
    runs["sharded"] = spatial["launches"]
    say("phase 14: the oracle copy and the per-octave public names")
    runs["per_octave"] = oracle_phase(frames[0], dev)
    for r in rows:
        r["launches"] = runs[LAUNCHES_FROM[r["name"]]][r["name"]]
        check(r["launches"] > 0, f"{r['name']} was launched no time in the "
              f"run of its path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
