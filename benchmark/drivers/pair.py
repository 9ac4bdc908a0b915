"""Pair requests, as ``popsift-match --geom homography`` runs them: a
closed loop of one client that extracts two host frames in matching mode
(``PopSift.enqueue(frame).getDev()`` each), ratio-test matches them on
the card (``match_descriptors``), reads the accepted matches back, and
verifies them with homography RANSAC (``ransac_homography``), whose
inlier set it reads back.

Traffic parameters: ``pool`` pairs made from the seed by the
configuration's pair scene, cycled in order; ``keep_share``, the share
of the window's requests, drawn from the seed across the whole window,
that keep their extraction for the check besides the first pass over
the pool. Each kept request is judged against the reference; every
request's counts of matches and inliers are kept, and a request whose
counts differ from every judged request of its pair is a miss of its
own (``count_mismatch``, compared exactly). The configuration's
``match`` gives the ratio, the RANSAC gate in pixels and the number of
hypotheses; the sample ranks of each pool pair are drawn once from the
seed in set-up and handed to the program's RANSAC (``ranks=``) and to
the reference's alike.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import compare, scenes
from reference import geometry, sift as ref_sift
from reference.gauss import Params

UNIT = "pairs"
FIELDS = ("x", "y", "sigma", "octave", "orientations", "ori_valid",
          "descriptors", "desc_to_kp")


def prepare(ctx: dict, stamps: dict) -> dict:
    from popsift_tpu_torch.api import PopSift
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.ops.matching import match_descriptors
    from popsift_tpu_torch.sfm.twoview import ransac_homography
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
    pool = [scene.pair(cfg["scene"], h, w, ctx["seed"], k, dev)
            for k in range(int(traffic["pool"]))]
    m = cfg["match"]
    gen = torch.Generator().manual_seed(ctx["seed"])
    raw = [torch.randint(0, 2 ** 31 - 1, (int(m["hypotheses"]), 4),
                         generator=gen) for _ in pool]
    rng = np.random.default_rng([ctx["seed"], 1])
    keep = rng.random(1 << 18) < float(traffic["keep_share"])
    stamps["frames_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state = dict(ps=PopSift(SiftConfig(**cfg["sift"]), mode="matching",
                            device=dev),
                 match=match_descriptors, ransac=ransac_homography,
                 pool=pool, raw=raw, keep=keep, cfg=cfg,
                 params=Params(cfg["sift"]), device=dev)
    # the plan, cuBLAS, cuSOLVER, the kernels, and each pair's RANSAC rows
    for i in range(len(pool)):
        request(state, i, False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps["warmup_s"] = time.perf_counter() - t
    return state


def request(state: dict, i: int, traced: bool):
    ps, dev = state["ps"], state["device"]
    k = i % len(state["pool"])
    left, right, _ = state["pool"][k]
    m = state["cfg"]["match"]
    sync = (lambda: torch.cuda.synchronize(dev)) \
        if traced and dev.type == "cuda" else (lambda: None)
    span = torch.profiler.record_function if traced else (
        lambda name: contextlib.nullcontext())
    t = [time.perf_counter()]
    with span("bench/extract"):
        dl = ps.enqueue(left).getDev()
        dr = ps.enqueue(right).getDev()
        sync()
    t.append(time.perf_counter())
    with span("bench/match"):
        res = state["match"](dl.raw.desc, dl.raw.desc_valid, dr.raw.desc,
                             dr.raw.desc_valid, ratio=float(m["ratio"]))
        acc = res.accept.cpu().numpy()
        sync()
    t.append(time.perf_counter())
    with span("bench/ransac"):
        host = lambda a: a.cpu().numpy()
        rows = np.nonzero(acc)[0]
        bi = host(res.best_idx)[rows]
        l_kp, r_kp = host(dl.raw.desc_kp), host(dr.raw.desc_kp)
        pl = np.stack([host(dl.raw.x)[l_kp[rows]], host(dl.raw.y)[l_kp[rows]]],
                      1)
        pr = np.stack([host(dr.raw.x)[r_kp[bi]], host(dr.raw.y)[r_kp[bi]]], 1)
        N = len(rows)
        inl = np.zeros(0, bool)
        if N >= 4:
            cap = max(64, 1 << (N - 1).bit_length())

            def pad(a):
                out = np.zeros((cap, 2), np.float32)
                out[:N] = a
                return torch.from_numpy(out).to(dev)

            vmask = torch.from_numpy(np.arange(cap) < N).to(dev)
            ranks = (state["raw"][k] % N).to(dev)
            g = state["ransac"](None, pad(pl), pad(pr), vmask,
                                thresh=float(m["thresh_px"]) ** 2,
                                ranks=ranks)
            inl = host(g.inliers)[:N]
        sync()
    t.append(time.perf_counter())
    rec = {"pair": k, "rows": rows, "best": bi, "inliers": inl}
    if i < min_requests(state) or state["keep"][i % len(state["keep"])]:
        rec["raw"] = (dl.raw, dr.raw)
    if traced:
        rec["layers"] = {name: [b - a] for name, a, b in zip(
            ("extract", "match", "ransac"), t[:-1], t[1:])}
    return 1, rec


def min_requests(state: dict) -> int:
    """One pass over the pool."""
    return len(state["pool"])


def release(state: dict, records: list) -> None:
    """The kept requests' extractions to the host, then the program's
    device state dropped."""
    from popsift_tpu_torch.api import FeaturesHost
    for rec in records:
        if "raw" in rec:
            rec["host"] = [_features(FeaturesHost, r) for r in rec.pop("raw")]
    state.pop("ps", None)


def _features(features_host, raw) -> tuple:
    """(host features, padded descriptor row -> host descriptor row)."""
    fh = features_host(raw)
    dv = raw.desc_valid.cpu().numpy()
    row_of = -np.ones(dv.shape[0], np.int64)
    row_of[np.nonzero(dv)[0]] = np.arange(int(dv.sum()))
    return {k: getattr(fh, k) for k in FIELDS}, row_of


def _reference(state: dict, k: int, dtype) -> dict:
    key = (k, dtype)
    refs = state.setdefault("refs", {})
    if key not in refs:
        dev, m = state["device"], state["cfg"]["match"]
        left, right, _ = state["pool"][k]
        fl, fr = (ref_sift.extract(torch.from_numpy(im).to(dev),
                                   state["params"], dtype)
                  for im in (left, right))
        lr, rr = geometry.ratio_matches(
            torch.from_numpy(fl["descriptors"]).to(dev),
            torch.from_numpy(fr["descriptors"]).to(dev),
            float(m["ratio"]), dtype)
        lr, rr = lr.numpy(), rr.numpy()
        N = len(lr)
        inl = np.zeros(0, bool)
        if N >= 4:
            kl, kr = fl["desc_to_kp"][lr], fr["desc_to_kp"][rr]
            x1 = torch.from_numpy(np.stack([fl["x"][kl], fl["y"][kl]], 1))
            x2 = torch.from_numpy(np.stack([fr["x"][kr], fr["y"][kr]], 1))
            ranks = state["raw"][k] % N
            inl = geometry.ransac_homography(
                x1.to(dev), x2.to(dev), ranks.to(dev),
                float(m["thresh_px"]) ** 2).cpu().numpy()
        refs[key] = dict(left=fl, right=fr, matches=np.stack([lr, rr], 1),
                         inliers=inl)
    return refs[key]


def judge(state: dict, records: list, dtype) -> tuple:
    """The worst over the kept requests: the shares of keypoints and
    descriptors (both frames), of ratio-test matches and of inliers
    without a partner in the reference; and the requests whose counts
    of matches and inliers no judged request of their pair shares."""
    worst = {"kp_miss_pct": 0.0, "desc_miss_pct": 0.0, "match_miss_pct": 0.0,
             "inlier_miss_pct": 0.0}
    info = {"requests_judged": 0, "matches": [], "inliers": [],
            "ref_matches": [], "ref_inliers": [], "keypoints": []}
    judged = {}
    for rec in records:
        if "host" in rec:
            judged.setdefault(rec["pair"], set()).add(_counts(rec))
    worst["count_mismatch"] = sum(_counts(rec) not in judged.get(
        rec["pair"], ()) for rec in records)
    for rec in records:
        if "host" not in rec:
            continue
        ref = _reference(state, rec["pair"], dtype)
        (gl, row_l), (gr, row_r) = rec["host"]
        nl, _, pair_l = compare.feature_numbers(gl, ref["left"],
                                                state["params"])
        nr, _, pair_r = compare.feature_numbers(gr, ref["right"],
                                                state["params"])
        for n in ("kp_miss_pct", "desc_miss_pct"):
            worst[n] = max(worst[n], nl[n], nr[n])
        got = np.stack([row_l[rec["rows"]], row_r[rec["best"]]], 1)
        worst["match_miss_pct"] = max(worst["match_miss_pct"],
                                      compare.pairs_miss_pct(
                                          got, ref["matches"], pair_l, pair_r))
        gin = got[rec["inliers"]] if len(rec["inliers"]) else got[:0]
        rin = ref["matches"][ref["inliers"]] if len(ref["inliers"]) \
            else ref["matches"][:0]
        worst["inlier_miss_pct"] = max(worst["inlier_miss_pct"],
                                       compare.pairs_miss_pct(
                                           gin, rin, pair_l, pair_r))
        info["requests_judged"] += 1
        info["matches"].append(int(len(got)))
        info["inliers"].append(int(len(gin)))
        info["ref_matches"].append(int(len(ref["matches"])))
        info["ref_inliers"].append(int(len(rin)))
        info["keypoints"].append([int(len(gl["x"])), int(len(gr["x"]))])
    if not info["requests_judged"]:
        worst = {k: float("inf") for k in worst}
    return worst, info


def _counts(rec: dict) -> tuple:
    return len(rec["rows"]), int(np.count_nonzero(rec["inliers"]))


def control(state: dict, records: list, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` (features,
    matches, and RANSAC on its matches from the same ranks) put in the
    program's place, on the kept requests' pairs."""
    worst = {"kp_miss_pct": 0.0, "desc_miss_pct": 0.0, "match_miss_pct": 0.0,
             "inlier_miss_pct": 0.0}
    for k in sorted({rec["pair"] for rec in records if "host" in rec}):
        got = _reference(state, k, dtype)
        ref = _reference(state, k, torch.float64)
        nl, _, pair_l = compare.feature_numbers(got["left"], ref["left"],
                                                state["params"])
        nr, _, pair_r = compare.feature_numbers(got["right"], ref["right"],
                                                state["params"])
        for n in ("kp_miss_pct", "desc_miss_pct"):
            worst[n] = max(worst[n], nl[n], nr[n])
        worst["match_miss_pct"] = max(worst["match_miss_pct"],
                                      compare.pairs_miss_pct(
                                          got["matches"], ref["matches"],
                                          pair_l, pair_r))
        gin = got["matches"][got["inliers"]] if len(got["inliers"]) \
            else got["matches"][:0]
        rin = ref["matches"][ref["inliers"]] if len(ref["inliers"]) \
            else ref["matches"][:0]
        worst["inlier_miss_pct"] = max(worst["inlier_miss_pct"],
                                       compare.pairs_miss_pct(
                                           gin, rin, pair_l, pair_r))
    return worst


def work(state: dict, records: list) -> dict:
    """The padded rows each match of the stretch was given."""
    p = state["params"]
    cfg = state["cfg"]
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    rows = sum(c + c // 4 for c in (p.capacity(*d)
                                    for d in p.octave_dims(w, h)))
    return dict(match_rows=[(rows, rows)] * len(records))
