"""Extraction requests: a closed loop of one client that hands the
program host frames and waits for their features on the host.

Traffic parameters: ``pool`` distinct frames made from the seed by the
configuration's scene, cycled in order; ``batch`` frames a request
(1: ``PopSift.enqueue(frame).get()``; more: ``enqueue_batch(frames)``
then ``get()`` on each job); ``keep_share``, the share of requests,
drawn from the seed, whose results are kept for the check besides the
first pass over the pool (keeping every result would grow the process
by about a megabyte a 1080p frame inside the window). The kept results
are judged: identical results of one frame once, each distinct result
against the reference's features of its frame. Every request's counts
of keypoints and descriptors are kept, and a request whose counts
differ from every judged result of its frame is a miss of its own
(``count_mismatch``, compared exactly).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import bounds, compare, scenes
from reference import sift as ref_sift
from reference.gauss import Params, filter_tables

UNIT = "frames"
FIELDS = ("x", "y", "sigma", "octave", "orientations", "ori_valid",
          "descriptors", "desc_to_kp")


def prepare(ctx: dict, stamps: dict) -> dict:
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    stamps["cuda_context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        from popsift_tpu_torch.ops.kernels import build
        build.load_library()
    stamps["kernel_library_s"] = time.perf_counter() - t
    t = time.perf_counter()
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    scene = scenes.load(ctx["bench"], cfg["scene"])
    pool = [scene.frame(cfg["scene"], h, w, ctx["seed"], k, dev)
            for k in range(int(traffic["pool"]))]
    stamps["frames_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ps = PopSift(SiftConfig(**cfg["sift"]), mode="extracting", device=dev)
    batch = int(traffic["batch"])
    rng = np.random.default_rng([ctx["seed"], 2])
    state = dict(ps=ps, pool=pool, batch=batch, params=Params(cfg["sift"]),
                 device=dev, cfg=cfg,
                 keep=rng.random(1 << 18) < float(traffic["keep_share"]))
    for i in range(2):                # the plan, its constants, the kernels
        request(state, i, False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps["warmup_s"] = time.perf_counter() - t
    return state


def _frames_of(state: dict, i: int) -> list:
    b, n = state["batch"], len(state["pool"])
    return [(i * b + j) % n for j in range(b)]


def _host(fh) -> dict:
    return {k: getattr(fh, k) for k in FIELDS}


def _record(state: dict, i: int, ks: list, feats: list) -> dict:
    rec = {"frames": ks, "counts": [(len(f.x), len(f.descriptors))
                                    for f in feats]}
    if i < min_requests(state) or state["keep"][i % len(state["keep"])]:
        rec["features"] = [_host(f) for f in feats]
    return rec


def request(state: dict, i: int, traced: bool):
    ps, pool = state["ps"], state["pool"]
    ks = _frames_of(state, i)
    if not traced:
        if state["batch"] == 1:
            feats = [ps.enqueue(pool[ks[0]]).get()]
        else:
            feats = [j.get() for j in ps.enqueue_batch([pool[k] for k in ks])]
        return len(ks), _record(state, i, ks, feats)
    dev = state["device"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    n = len(ks)
    a = time.perf_counter()
    with torch.profiler.record_function("bench/dispatch"):
        if state["batch"] == 1:
            jobs = [ps.enqueue(pool[ks[0]])]
        else:
            jobs = ps.enqueue_batch([pool[k] for k in ks])
    b = time.perf_counter()
    sync()
    c = time.perf_counter()
    with torch.profiler.record_function("bench/readback"):
        feats = [j.get() for j in jobs]
    d = time.perf_counter()
    rec = _record(state, i, ks, feats)
    rec["layers"] = {"dispatch": [(b - a) / n] * n,
                     "readback": [(d - c) / n] * n}
    return n, rec


def min_requests(state: dict) -> int:
    """One pass over the pool."""
    return -(-len(state["pool"]) // state["batch"])


def release(state: dict, records: list) -> None:
    state.pop("ps", None)


def _reference(state: dict, k: int, dtype) -> dict:
    key = (k, dtype)
    refs = state.setdefault("refs", {})
    if key not in refs:
        img = torch.from_numpy(state["pool"][k]).to(state["device"])
        refs[key] = ref_sift.extract(img, state["params"], dtype)
    return refs[key]


def judge(state: dict, records: list, dtype) -> tuple:
    """The worst over every distinct result of the window: the share of
    keypoints and of descriptors without a partner in the reference."""
    distinct = {}            # frame -> list of distinct results
    for rec in records:
        for k, f in zip(rec["frames"], rec.get("features", [])):
            seen = distinct.setdefault(k, [])
            if not any(all(np.array_equal(f[n], g[n]) for n in FIELDS)
                       for g in seen):
                seen.append(f)
    judged = {k: {(len(f["x"]), len(f["descriptors"])) for f in v}
              for k, v in distinct.items()}
    worst = {"kp_miss_pct": 0.0, "desc_miss_pct": 0.0,
             "count_mismatch": sum(c not in judged.get(k, ())
                                   for r in records
                                   for k, c in zip(r["frames"], r["counts"]))}
    info = {"frames_judged": len(distinct),
            "results_judged": sum(len(r.get("features", []))
                                  for r in records),
            "distinct_results": sum(len(v) for v in distinct.values()),
            "keypoints": [], "descriptors": [], "kp_gap": 0.0,
            "desc_gap": 0.0, "over_capacity": 0}
    caps = _capacities(state)
    for k in sorted(distinct):
        ref = _reference(state, k, dtype)
        for got in distinct[k]:
            nums, gaps, _ = compare.feature_numbers(got, ref,
                                                    state["params"])
            for n, v in nums.items():
                worst[n] = max(worst[n], v)
            for n, v in gaps.items():
                info[n] = max(info[n], v) if v == v else info[n]
        info["keypoints"].append(int(len(ref["x"])))
        info["descriptors"].append(int(len(ref["descriptors"])))
        info["over_capacity"] = max(info["over_capacity"], int(np.maximum(
            ref["candidates"] - caps, 0).sum()))
    return worst, info


def _capacities(state: dict) -> np.ndarray:
    """The configuration's candidate capacity of each octave."""
    p, f = state["params"], state["cfg"]["frame"]
    return np.asarray([p.capacity(*d)
                       for d in p.octave_dims(f["width"], f["height"])])


def control(state: dict, records: list, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place, on the frames the window served."""
    worst = {"kp_miss_pct": 0.0, "desc_miss_pct": 0.0}
    for k in sorted({k for rec in records for k in rec["frames"]}):
        nums, _, _ = compare.feature_numbers(
            _reference(state, k, dtype), _reference(state, k, torch.float64),
            state["params"])
        for n, v in nums.items():
            worst[n] = max(worst[n], v)
    return worst


def work(state: dict, records: list) -> dict:
    """Per frame of the stretch: the octave sizes, capacities, candidate
    and keypoint counts and scales, from the reference."""
    p = state["params"]
    cfg = state["cfg"]
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    dims = p.octave_dims(w, h)
    caps = _capacities(state).tolist()
    t = filter_tables(p)
    frames = []
    for rec in records:
        for k in rec["frames"]:
            ref = _reference(state, k, torch.float64)
            frames.append(dict(candidates=np.minimum(ref["candidates"],
                                                     caps),
                               refined_sigma=ref["refined_sigma"],
                               job_sigma=ref["job_sigma"]))
    return dict(dims=dims, caps=caps,
                half_spans=[s - 1 for s in t["inc_span"][1:]],
                levels_searched=p.total_levels - 3, frames=frames,
                radius=bounds.loop_radius(p))
