"""Bundle-adjustment requests on BAL problems: a closed loop of one client
that uploads a problem's host arrays (``sfm/bal.py::problem_from_bal``),
runs ``sfm/ba.py::bundle_adjust(p, iters=...)`` with its defaults (the
dense or CG Schur step chosen by shape), and reads the refined cameras,
the points and the costs back.

Traffic parameters: ``pool`` problems made in set-up from the seed by
the configuration's scene (``scenes/<kind>.py::bal_scene``, at the
configuration's counts), cycled in order; ``keep_share``, the share of
the window's requests, drawn from the seed across the whole window, that
keep their cameras and points for the check besides the first pass over
the pool.

What decides ``correct`` (the reference is ``reference/bal.py``, float64
from the same start, on the card). No camera is fixed, so only
quantities that the similarity gauge leaves alone are compared, on the
kept requests:

* ``cost_gap_pct``: the largest gap of an iteration's cost to the
  reference's (the 10 costs), as a share of the reference's cost before
  that iteration: a step is judged against what it started from. (A
  first step removes 99.6 % of the cost, so relative to the cost after
  it, f32's last bits show as a 1 % gap.)
* ``reproj_gap_px``: the 99.9th percentile of the distance between an
  observation's final reprojection through the program's cameras and
  points and through the reference's (one observation in a thousand may
  lie further: the weakest two-view points still move at the last
  iterations, where the f32 accept test decides on rounding);
* ``focal_gap_pct``, ``k1_gap``, ``k2_gap``: the largest gap of a
  camera's final focal length (relative) and distortion to the
  reference's;
* ``repeat_cost_gap_pct``: every request's final cost against the first
  request of its problem (the sums add in no fixed order on the card).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import scenes
from reference import bal as ref_bal

UNIT = "problems"


def prepare(ctx: dict, stamps: dict) -> dict:
    from popsift_tpu_torch.sfm.ba import bundle_adjust
    from popsift_tpu_torch.sfm.bal import problem_from_bal
    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    stamps["cuda_context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    scene = scenes.load(ctx["bench"], cfg["scene"])
    n = cfg["problem"]
    pool = []
    for k in range(int(traffic["pool"])):
        fields, _ = scene.bal_scene([ctx["seed"], k], n["cameras"],
                                    n["points"], n["observations"])
        pool.append(dict(cams=fields["cams"].astype(np.float32),
                         points=fields["points"].astype(np.float32),
                         obs_cam=fields["obs_cam"], obs_pt=fields["obs_pt"],
                         obs_uv=fields["obs_uv"].astype(np.float32)))
    rng = np.random.default_rng([ctx["seed"], 1])
    keep = rng.random(1 << 16) < float(traffic["keep_share"])
    stamps["problems_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state = dict(ba=bundle_adjust, upload=problem_from_bal, pool=pool,
                 keep=keep, iters=int(cfg["lm"]["iters"]), device=dev)
    # cuBLAS, cuSOLVER and every shape of the LM loop, on each problem
    for k in range(len(pool)):
        request(state, k, False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps["warmup_s"] = time.perf_counter() - t
    return state


def request(state: dict, i: int, traced: bool):
    dev = state["device"]
    k = i % len(state["pool"])
    sync = (lambda: torch.cuda.synchronize(dev)) \
        if traced and dev.type == "cuda" else (lambda: None)
    span = torch.profiler.record_function if traced else (
        lambda name: contextlib.nullcontext())
    t = [time.perf_counter()]
    with span("bench/upload"):
        p = state["upload"](state["pool"][k], dev)
        sync()
    t.append(time.perf_counter())
    with span("bench/ba"):
        out, costs = state["ba"](p, iters=state["iters"])
        sync()
    t.append(time.perf_counter())
    with span("bench/readback"):
        cams, points = out.cams.cpu().numpy(), out.points.cpu().numpy()
        costs = costs.cpu().numpy()
    t.append(time.perf_counter())
    rec = {"problem": k, "costs": costs}
    if i < min_requests(state) or state["keep"][i % len(state["keep"])]:
        rec["cams"], rec["points"] = cams, points
    if traced:
        rec["layers"] = {name: [b - a] for name, a, b in zip(
            ("upload", "ba", "readback"), t[:-1], t[1:])}
    return 1, rec


def min_requests(state: dict) -> int:
    """One pass over the pool."""
    return len(state["pool"])


def release(state: dict, records: list) -> None:
    """Every result is on the host already; the program is dropped."""
    state.pop("ba", None)
    state.pop("upload", None)


def _reference(state: dict, k: int, dtype) -> dict:
    """The reference's run of problem ``k`` in ``dtype`` on the run's
    device: cameras, points, costs, the start's cost and the
    reprojections (float64)."""
    refs = state.setdefault("refs", {})
    if (k, dtype) not in refs:
        dev, prob = state["device"], state["pool"][k]
        T = {n: torch.from_numpy(v).to(dev) for n, v in prob.items()}
        args = (T["obs_cam"], T["obs_pt"], T["obs_uv"].double())
        cams, points, costs = ref_bal.bundle_adjust(
            T["cams"].double(), T["points"].double(), *args,
            iters=state["iters"], dtype=dtype)
        refs[(k, dtype)] = dict(
            cams=cams.double(), points=points.double(),
            costs=costs.double().cpu().numpy(),
            start=_cost(T["cams"], T["points"], *args),
            uv=ref_bal.reprojections(cams, points, T["obs_cam"],
                                     T["obs_pt"]))
    return refs[(k, dtype)]


def _cost(cams, points, obs_cam, obs_pt, obs_uv) -> float:
    r = ref_bal.reprojections(cams, points, obs_cam, obs_pt) - obs_uv
    return float((r * r).sum())


def _gaps(state: dict, k: int, cams, points, costs, ref) -> dict:
    """The numbers of one result (cameras and points as tensors on the
    run's device, costs as numpy) against the reference's ``ref``."""
    prob, dev = state["pool"][k], state["device"]
    oc = torch.from_numpy(prob["obs_cam"]).to(dev)
    op = torch.from_numpy(prob["obs_pt"]).to(dev)
    uv = ref_bal.reprojections(cams, points, oc, op)
    before = np.concatenate([[ref["start"]], ref["costs"][:-1]])
    rc = ref["cams"]
    cams = cams.double()
    return {
        "cost_gap_pct": float(np.max(100.0 * np.abs(
            np.asarray(costs, np.float64) - ref["costs"]) / before)),
        "reproj_gap_px": float(torch.quantile(
            (uv - ref["uv"]).norm(dim=1).float().cpu(), 0.999)),
        "focal_gap_pct": float((100.0 * (cams[:, 6] - rc[:, 6]).abs()
                                / rc[:, 6]).max()),
        "k1_gap": float((cams[:, 7] - rc[:, 7]).abs().max()),
        "k2_gap": float((cams[:, 8] - rc[:, 8]).abs().max())}


def _worst(worst: dict, nums: dict) -> None:
    for n, v in nums.items():
        worst[n] = max(worst.get(n, 0.0), v if v == v else float("inf"))


def judge(state: dict, records: list, dtype) -> tuple:
    """The worst of each number over the kept requests (module
    docstring), and readings for the record."""
    dev = state["device"]
    worst = {"cost_gap_pct": 0.0, "reproj_gap_px": 0.0,
             "focal_gap_pct": 0.0, "k1_gap": 0.0, "k2_gap": 0.0}
    first = {}
    repeat = 0.0
    for rec in records:
        c = float(rec["costs"][-1])
        c0 = first.setdefault(rec["problem"], c)
        gap = 100.0 * abs(c - c0) / c0 if c0 > 0 else float("inf")
        repeat = max(repeat, gap if gap == gap else float("inf"))
    info = {"requests_judged": 0, "start_cost": {}, "ref_costs": {},
            "costs": {}, "final_costs": {}}
    for rec in records:
        if "cams" not in rec:
            continue
        k = rec["problem"]
        ref = _reference(state, k, dtype)
        cams = torch.from_numpy(rec["cams"]).to(dev)
        points = torch.from_numpy(rec["points"]).to(dev)
        _worst(worst, _gaps(state, k, cams, points, rec["costs"], ref))
        info["requests_judged"] += 1
        info["start_cost"][k] = ref["start"]
        info["ref_costs"][k] = ref["costs"].tolist()
        info["costs"].setdefault(k, [float(c) for c in rec["costs"]])
        info["final_costs"].setdefault(k, []).append(
            float(rec["costs"][-1]))
    if not info["requests_judged"]:
        worst = {n: float("inf") for n in worst}
    worst["repeat_cost_gap_pct"] = repeat
    return worst, info


def control(state: dict, records: list, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place, on the kept requests' problems."""
    worst = {"repeat_cost_gap_pct": 0.0}
    for k in sorted({rec["problem"] for rec in records if "cams" in rec}):
        got = _reference(state, k, dtype)
        ref = _reference(state, k, torch.float64)
        _worst(worst, _gaps(state, k, got["cams"], got["points"],
                            got["costs"], ref))
    return worst


def work(state: dict, records: list) -> dict:
    """Each request's counts for ``harness/ba_bounds.py``: cameras,
    points, observations and ordered pairs of a track's observations."""
    counts = {}
    for k, prob in enumerate(state["pool"]):
        L = np.bincount(prob["obs_pt"], minlength=len(prob["points"]))
        counts[k] = (len(prob["cams"]), len(prob["points"]),
                     len(prob["obs_pt"]), int((L.astype(np.int64) ** 2).sum()))
    return dict(ba=[counts[rec["problem"]] for rec in records],
                iters=state["iters"])
