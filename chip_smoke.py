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
   1e-4 on the 0..255 scale, masks exact, refinement state within 1e-5
   with the accept masks exact, histograms and descriptors within 1e-5 x
   the row's max; the batched entries of K1 and K2 on four frames
   (seeds 0-3), exact; median time of kernel and plain over 20 runs,
   timed with CUDA events;
4. the main path ``PopSift(SiftConfig(extrema_capacity=8192),
   device="cuda").enqueue(frame).get()`` with every launch counter reset
   just before it: 2110 keypoints / 2505 descriptors, no dropped
   candidate, every kernel of the path launched; finite outputs; the two
   golden scenes (tests/golden) within the golden tolerances; warm
   ms/frame of the kernel path and of the plain-PyTorch path on the
   card, and the counts of the ``SiftConfig()`` default;
5. the batch path ``enqueue_batch`` of the four frames, counters reset
   just before it: K5 once per (octave, level), batched K1 and K2 once
   per octave; each frame equal to its own ``enqueue`` (counts, masks and
   integer fields exact, float fields bit-equal or within 1e-6 x the
   field's magnitude); warm ms/frame of the batch against single-frame
   ``enqueue`` and the plain batch; then ``PopSift.calibrate([frame])``
   with the counters reset just before it (its detect-only probe
   launches K5 and the dense K1 entry and nothing else) and ``enqueue``:
   no octave saturates its calibrated capacity.

TF32 is switched off for matmuls and cuDNN (the plain versions must run
in full f32). The second line before the last is a JSON object with one
entry per kernel entry (``launches`` from the run of its path: phase 4
for the single-frame entries, phase 5 for the batched ones); the last
line is the device record. ``--profile DIR`` also writes a
torch.profiler table of one main-path run to DIR/profile.txt and prints
its device-op count and device busy time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FRAME_HW = (1080, 1920)
N_FRAMES = 4           # the batch of phases 3 and 5: make_frame seeds 0..3
BENCH_KEYPOINTS, BENCH_DESCRIPTORS = 2110, 2505
# kernel entries of each path (phase 4: single frame, phase 5: batch)
MAIN_PATH = ("blur_dog", "extrema_mask", "refine", "orientation_hist",
             "descriptor_loop")
BATCH_PATH = ("blur_dog", "extrema_mask_batched", "refine_batched",
              "orientation_hist", "descriptor_loop")
PROBE_PATH = ("blur_dog", "extrema_mask")   # the calibration probe
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


def rel_row_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / (row max of |ref|) over rows with a non-zero
    reference, and max |got| over rows whose reference is all zero."""
    rowmax = ref.abs().amax(1, keepdim=True)
    err = (got - ref).abs()
    rel = torch.where(rowmax > 0, err / rowmax.clamp(min=1e-30), err)
    return float(rel.max()) if rel.numel() else 0.0


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
    from popsift_tpu_torch.ops.kernels import (ENTRIES, blur_dog, desc,
                                               extrema_mask, orient, refine)
    from popsift_tpu_torch.ops.pyramid import (build_pyramid,
                                               build_pyramid_frames)
    from popsift_tpu_torch.pipeline import build_extract_plan

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

    def row(name, err, ms, plain_ms, what=f"per frame (all {nO} octaves)"):
        mod, _, replaces = ENTRIES[name]
        rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
        say(f"{name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms {what}")

    # K5 blur + DoG: every (octave, level) of the frame, from the same
    # level l-1 as input
    bargs = [(blurs[o][l - 1:l], plan.pyramid.inc_kernels[l])
             for o in range(nO) for l in range(1, cfg.total_levels)]
    err = 0.0
    for src, k in bargs:
        got = blur_dog.blur_dog(src, k)
        want = blur_dog.blur_dog_torch(src, k)
        sync(dev)
        err = max(err, float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
    check(err <= 1e-4, f"K5 blur/DoG differ by {err} (limit 1e-4)")
    say(f"K5 {'bit-equal to' if err == 0 else 'within 1e-4 of'} its plain "
        f"version over {len(bargs)} levels")
    row(blur_dog.NAME, err,
        median_ms(lambda: [blur_dog.blur_dog(*a) for a in bargs], dev, reps),
        median_ms(lambda: [blur_dog.blur_dog_torch(*a) for a in bargs], dev,
                  reps))

    # K1 mask
    dstk = [d[:Z + 2].contiguous() for d in dogs]
    err = 0
    for d in dstk:
        k = extrema_mask.candidate_mask(d, thr1)
        p = extrema_mask.candidate_mask_torch(d, thr1)
        sync(dev)
        err = max(err, int((k != p).sum()))
    check(err == 0, f"K1 mask differs from its plain version in {err} px")
    row(extrema_mask.NAME, float(err),
        median_ms(lambda: [extrema_mask.candidate_mask(d, thr1)
                           for d in dstk], dev, reps),
        median_ms(lambda: [extrema_mask.candidate_mask_torch(d, thr1)
                           for d in dstk], dev, reps))

    # K2 refine
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
                           for a in args], dev, reps))

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
    row(orient.NAME, float((hk - hp).abs().max()),
        median_ms(lambda: [orient.orientation_hist(*a) for a in oargs],
                  dev, reps),
        median_ms(lambda: [orient.orientation_hist_torch(*a)
                           for a in oargs], dev, reps))

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
    dk = torch.cat([desc.descriptor_loop(*a) for a in dargs])
    dp = torch.cat([desc.descriptor_loop_torch(*a) for a in dargs])
    rel = rel_row_err(dk, dp)
    check(rel <= 1e-5, f"K4 descriptors differ by {rel} x row max")
    row(desc.NAME, float((dk - dp).abs().max()),
        median_ms(lambda: [desc.descriptor_loop(*a) for a in dargs],
                  dev, reps),
        median_ms(lambda: [desc.descriptor_loop_torch(*a) for a in dargs],
                  dev, reps))
    del blurs, dogs, bargs, args, oargs, dargs

    # batched K1 and K2 on all frames' stacks (frames back to back on the
    # layer axis), one launch per octave each
    F = len(frames)
    what = f"per batch of {F} frames (all {nO} octaves)"
    _, bdogs = build_pyramid_frames(
        torch.from_numpy(np.stack(frames)).to(dev), plan.pyramid)
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
            d, F, thr1) for d in bdogs], dev, reps), what)

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
                           for a in bargs], dev, reps), what)
    return rows


def golden_phase(dev) -> None:
    """The port on the card against the oracle goldens of
    tests/golden (tolerances of tests/test_golden.py:21-24)."""
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    cases = {"scene64_default": (synthetic_image(64, 80, seed=3),
                                 SiftConfig(octaves=3)),
             "scene120_default": (synthetic_image(120, 160, seed=7),
                                  SiftConfig(octaves=4))}
    for name, (img, cfg) in cases.items():
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
    check(launches["blur_dog"] == n_oct * (cfg.total_levels - 1),
          f"K5 launched {launches['blur_dog']} times for {n_oct} octaves")
    for name in ("extrema_mask_batched", "refine_batched"):
        check(launches[name] == n_oct,
              f"{name} launched {launches[name]} times for {n_oct} octaves")
    for name in ("extrema_mask", "refine"):
        check(launches[name] == 0, f"single-frame {name} ran in the batch")

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


def profile_phase(frame: np.ndarray, dev, out_dir: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.pipeline import build_extract_plan, extract
    plan = build_extract_plan(SiftConfig(extrema_capacity=8192),
                              *frame.shape)
    extract(frame, plan, dev)
    sync(dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        extract(frame, plan, dev)
        sync(dev)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "profile.txt")
    avg = prof.key_averages()
    with open(path, "w") as fh:
        for key in ("self_cuda_time_total", "cpu_time_total"):
            fh.write(avg.table(sort_by=key, row_limit=40))
            fh.write("\n")
    dev_ops = [e for e in avg if e.device_type == DeviceType.CUDA]
    say(f"profile: {sum(e.count for e in dev_ops)} device ops, device busy "
        f"{sum(e.self_device_time_total for e in dev_ops) / 1e3:.3f} ms, "
        f"host launch calls "
        f"{sum(e.count for e in avg if 'LaunchKernel' in e.key)}; "
        f"table in {path}")


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
    card_phase(dev)
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
    batch_launches = batch_phase(frames, dev)
    for r in rows:
        r["launches"] = (launches if r["name"] in MAIN_PATH
                         else batch_launches)[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
