#!/usr/bin/env python3
"""Time the kernels of the extraction path the way it calls them, and
the path end to end, on one NVIDIA GPU: the extremum mask (K1), the
compaction, the refinement (K2), the orientation histograms (K3), the
descriptors (K4), the blur + DoG (K5), the chain front's blur chain
(K7) and the window route's window copy (K6, single frame and batch).

    python3 popsift_tpu_torch/tools/kernel_times.py [--tree DIR] [--reps N]
                                                    [--sass]

Runs ``extract`` once on the 1080p bench frame (``bench.make_frame``,
seed 0, ``SiftConfig(extrema_capacity=8192)``), times ``extract`` end to
end (warm, host clock around work that ends in a synchronize; a tree
that captures the extraction as a CUDA graph replays it) and
``extract_batch`` of the frames of seeds 0-3 the same way (per frame),
records every call the eager path of a fresh plan makes to the
wrappers of K1, the compaction, K2, K3, K4 and K5 with its arguments
(a tree whose path compacts and refines per octave records those calls,
with the counts they were given), records the K7 calls of one ``extract(...,
front="chain")`` of the frame, the K6 calls of one ``extract(...,
detect="windows")`` of the frame (``K6``) and of one ``extract_batch(...,
detect="windows")`` of the four frames (``K6_batched``, per batch) and
the K1 calls of one ``extract`` of :func:`synthetic_image` of the
same size (``K1_textured``) the same way,
and replays each kernel's calls of one frame: the median time per frame
over ``--reps`` replays with CUDA events around the wrapper calls, and
the device time of the kernels themselves from one ``torch.profiler``
pass over a replay (with the count of device records, to compare against
the launches, each launch's own time in launch order, and the device
time of every op of the replay, for a stage that is PyTorch ops).

``--tree DIR`` times the package of another checkout of this repository
(default: the checkout this file lies in). To compare two versions of a
kernel, unpack the other commit beside this one and run the script on
the two trees in turns (other, this, this, other) in one process chain on one
card: times taken on different cards or days do not compare.

``--sass`` also compiles the tree's sources of those kernels
(``csrc/extrema_mask.cu``, ``compact.cu``, ``refine.cu``, ``orient.cu``,
``desc.cu``, ``blur_dog.cu``, ``blur_chain.cu``, where present) with
``-Xptxas -v`` and
prints each kernel's registers, spills and shared memory, and the number
of SASS instructions ``cuobjdump -sass`` lists for it.

Prints one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """The golden scenes' generator, tests/conftest.py::synthetic_image
    (that module imports jax, which the port's tools must not)."""
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

def sass_report(tree: str) -> dict:
    """Registers, spills, shared memory and SASS instruction counts of
    the kernel sources of ``tree``."""
    sys.path.insert(0, tree)
    from popsift_tpu_torch.ops.kernels import build
    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("extrema_mask", "compact", "refine", "orient", "desc",
                     "blur_dog", "blur_chain"):
            src = os.path.join(tree, "popsift_tpu_torch", "csrc", f"{name}.cu")
            if not os.path.exists(src):
                continue
            cubin = os.path.join(tmp, f"{name}.cubin")
            res = subprocess.run(
                [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", src,
                 "-o", cubin], capture_output=True, text=True, check=True)
            info = re.findall(
                r"Function properties for (\S+)\n\s*(.*?)\n.*?Used (\d+) "
                r"registers(.*?)\n", res.stderr, flags=re.S)
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True).stdout
            counts = {}
            for block in sass.split("Function : ")[1:]:
                fn = block.split("\n", 1)[0].strip()
                ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\d\s+)?"
                                 r"([A-Z0-9_.]+)", block, flags=re.M)
                by = {}
                for _, op in ops:
                    by[op.split(".")[0]] = by.get(op.split(".")[0], 0) + 1
                counts[fn] = {"instructions": len(ops), "top": dict(sorted(
                    by.items(), key=lambda kv: -kv[1])[:8])}
            out[name + "_ptxas"] = [
                l.strip() for l in res.stderr.splitlines()
                if "Used" in l or "spill" in l]
            out[name] = [{"function": fn, "stack_spills": props.strip(),
                          "registers": int(regs), "memory": rest.strip(", "),
                          **counts.get(fn, {})}
                         for fn, props, regs, rest in info]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import bench   # numpy-only frame generator at the checkout's root
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops import descriptors as D
    from popsift_tpu_torch.ops import extrema as E
    from popsift_tpu_torch.ops import orientation as O
    from popsift_tpu_torch.ops import pyramid as P
    from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                            extract_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    frame = bench.make_frame(1080, 1920, seed=0)
    plan = build_extract_plan(SiftConfig(extrema_capacity=8192),
                              *frame.shape)
    frames = np.stack([bench.make_frame(1080, 1920, seed=s)
                       for s in range(4)])

    def warm_ms(fn, per):
        """Warm times in ms of ``fn()`` (host clock, ends in a
        synchronize), divided by ``per``, after two calls (the eager one
        and the one that captures the graph)."""
        fn()
        fn()
        torch.cuda.synchronize(dev)
        out = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out.append((time.perf_counter() - t0) * 1e3 / per)
        return out

    frame_ms = warm_ms(lambda: extract(frame, plan, dev), 1)
    batch_ms = warm_ms(lambda: extract_batch(frames, plan, dev),
                       frames.shape[0])

    calls = {"K1": [], "compact": [], "K2": [], "K3": [], "K4": [],
             "K5": [], "K7": [], "K6": [], "K6_batched": [],
             "K1_textured": []}
    depth = [0]
    # the kernels the next run records, and under which name
    active = set(calls) - {"K7", "K6", "K6_batched", "K1_textured"}
    suffix = [""]

    def record(kernel, mod, attr):
        fn = getattr(mod, attr, None)
        if fn is None:
            return

        def wrapper(*a, **k):
            # not the calls a recorded call makes
            if depth[0] == 0 and kernel in active:
                calls[kernel + suffix[0]].append((fn, a, k))
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        setattr(mod, attr, wrapper)

    record("K1", E, "candidate_mask")
    record("K1", E, "candidate_mask_octaves")
    record("compact", E, "_compact_kernel")       # one call for all octaves
    record("compact", E, "_compact_mask")         # per octave (older trees)
    record("K2", E, "refine_state_octaves")
    record("K2", E, "refine_state")
    record("K3", O, "orientation_hist")
    record("K3", O, "orientation_hist_octaves")
    record("K4", D, "descriptor_loop")
    record("K4", D, "descriptor_loop_octaves")
    record("K5", P, "blur_dog")
    record("K5", P, "blur_dog_thin")
    record("K7", P, "blur_chain")
    record("K6", E, "extract_windows")
    record("K6_batched", E, "extract_windows_batched")
    # a fresh plan for each recorded run: its first call runs eagerly
    fresh = lambda: build_extract_plan(SiftConfig(extrema_capacity=8192),
                                       *frame.shape)
    feats = extract(frame, fresh(), dev)
    active.clear()
    active.add("K7")
    extract(frame, fresh(), dev, front="chain")
    active.clear()
    active.update(("K6", "K6_batched"))
    extract(frame, fresh(), dev, detect="windows")
    extract_batch(frames, fresh(), dev, detect="windows")
    # K1 on a textured frame of the same size (the golden scenes'
    # generator, whose contrast gate skips less of it)
    active.clear()
    active.add("K1")
    suffix[0] = "_textured"
    extract(synthetic_image(*frame.shape), fresh(), dev)
    torch.cuda.synchronize(dev)
    depth[0] = 1           # the replays below record nothing more
    result = {"card": smi, "tree": tree,
              "keypoints": int(feats.n_keypoints),
              "descriptors": int(feats.n_descriptors),
              "frame_ms_median": statistics.median(frame_ms),
              "frame_ms_min": min(frame_ms),
              "batch_frames": int(frames.shape[0]),
              "batch_ms_per_frame_median": statistics.median(batch_ms),
              "batch_ms_per_frame_min": min(batch_ms)}

    for kernel, recorded in calls.items():
        def replay():
            for fn, a, k in recorded:
                fn(*a, **k)

        for _ in range(3):
            replay()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize(dev)
        ours = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and re.search(r"\(anonymous namespace\)::\w+_kernel", e.key)
                and "at::" not in e.key]
        result[kernel] = {
            "calls_per_frame": len(recorded),
            "event_ms_median": statistics.median(times),
            "event_ms_min": min(times),
            "device_ms": sum(e.self_device_time_total for e in ours) / 1e3,
            # every device op of the replay, PyTorch's included
            "device_ms_all": sum(e.self_device_time_total
                                 for e in prof.key_averages()
                                 if e.device_type == DeviceType.CUDA) / 1e3,
            "device_records": sum(e.count for e in ours),
            # each launch of the replay, in launch order
            "device_us_each": [
                round(e.device_time, 2) for e in sorted(
                    (e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and re.search(r"\(anonymous namespace\)::\w+_kernel",
                                   e.name) and "at::" not in e.name),
                    key=lambda e: e.time_range.start)]}
    if args.sass:
        result["sass"] = sass_report(tree)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
