"""The f32 spread behind two of the card tests' tolerances.

``tests/test_torch_sfm_cuda.py`` holds one GN step of each kind (dense,
CG) on the card to the CPU's at 100 cameras / 40,000 points, and the
24-node translation solves (dense, CG) to the CPU's and to the f64
solve. Both systems are badly conditioned in f32, and the card's atomic
sums take another order on every run, so one comparison is one draw of
the rounding. This tool makes many draws:

  * ``--reps`` runs of each GN step on ``--device`` against the CPU's f32
    and f64 steps (:func:`gn_step_gaps`: largest entries, the GN model's
    norm, f64 against f64),
  * ``--reorder`` runs of each GN step on the CPU with the observations
    in another random order (the same sums in another order),
  * ``--reps`` runs of the 24-node solves on ``--device``
    (:func:`translation_gaps`),

prints one line a run and, last, a JSON object with the smallest and
largest value of each gap. The scenes come from ``tools/sfm_scenes.py``.

Usage:

    python -m popsift_tpu_torch.tools.step_spread [--device cuda]
        [--reps 10] [--reorder 0] [--cams 100] [--points 40000]
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch

from popsift_tpu_torch.sfm import ba as B
from popsift_tpu_torch.sfm import global_sfm as G
from popsift_tpu_torch.tools.sfm_scenes import (BA_CAMS, BA_POINTS,
                                                averaging_problems, ba_scene)
from popsift_tpu_torch.utils.device import resolve_device

LAM = 1e-3
# how far the card's f32 translation solves may sit from the CPU's and from
# the f64 solve, in units of the solution's scale (see translation_gaps)
TRANSLATION_F32_TOL = 5e-4


def _gap(got, ref) -> float:
    """max |got - ref| / max |ref| (got moved to ref's device)."""
    ref = ref.double()
    return float((got.to(ref.device).double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def step_scene(n_cams: int = BA_CAMS, n_points: int = BA_POINTS) -> dict:
    """The GN-step problem: ``ba_scene(1)`` with 0.5 px noise and camera 1
    held too, so that the scale gauge is fixed (with only camera 0 fixed,
    S's smallest eigenvalue is lam and the step along that direction is
    rounding, ROADMAP C)."""
    fields, _ = ba_scene(1, noise_px=0.5, n_cams=n_cams, n_points=n_points)
    fixed = fields["cam_fixed"].copy()
    fixed[1] = True
    return dict(fields, cam_fixed=fixed)


def as_f64(p):
    """A BAProblem with its float fields in f64."""
    return p._replace(**{k: getattr(p, k).double()
                         for k in ("cams", "points", "intr", "obs_uv")})


def gn_steps() -> dict:
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
    entries are fixed by the arithmetic only to about 1e-2 at 100 cameras
    / 40,000 points: the CPU's own f32 step moves by up to 2.6e-2 x its
    max when the observations are merely reordered, and the card's atomic
    sums take another order on every run. So the gaps that hold the card
    are the f64 steps' (the same function, entry for entry) and the f32
    step's to the f64 step in the GN model's norm, which rounding along
    S's weak directions hardly moves; the largest-entry gaps are
    readings."""
    return dict(
        f64_card_cpu={"dc": _gap(got64[0], exact[0]),
                      "dp": _gap(got64[1], exact[1])},
        h_norm={"card_f64": gn_norm_gap(jac, got, exact, lam),
                "cpu_f64": gn_norm_gap(jac, ref, exact, lam)},
        card_cpu={"dc": _gap(got[0], ref[0]), "dp": _gap(got[1], ref[1])},
        f32_f64={"dc": _gap(ref[0], exact[0]), "dp": _gap(ref[1], exact[1])})


def translation_gaps(small, dev) -> tuple:
    """The 24-node translation problem solved dense and by CG on ``dev``,
    on the CPU in f32 and in f64: ({kind: the solve on ``dev``}, {kind:
    its gaps card against CPU, card against f64, CPU against f64, each the
    largest node distance over the f64 solve's scale}). The 1e6 gauge pin
    leaves the f32 systems badly conditioned: the CPU's own f32 solves sit
    1.1e-4 (dense) and 5.0e-5 (CG) x the scale from their f64 solve, and
    the card's LU and sums round the same system otherwise (2.4e-4 and
    1.3e-4 from the CPU's on an H100), so each is held to
    ``TRANSLATION_F32_TOL``."""
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


def _flat(prefix: str, d: dict) -> dict:
    """{"a": {"b": x}} -> {"prefix.a.b": x}."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(f"{prefix}.{k}", v))
        else:
            out[f"{prefix}.{k}"] = v
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--reorder", type=int, default=0)
    ap.add_argument("--cams", type=int, default=BA_CAMS)
    ap.add_argument("--points", type=int, default=BA_POINTS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cpu = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seen = collections.defaultdict(list)

    def record(line: str, gaps: dict) -> None:
        for k, v in gaps.items():
            seen[k].append(v)
        print(line, json.dumps(gaps), flush=True)

    fields = step_scene(args.cams, args.points)
    pc, pd = (B.problem_from_numpy(fields, d) for d in (cpu, dev))
    p64, pd64 = as_f64(pc), as_f64(pd)
    jac = (*B._jacobians(p64), pc.obs_cam, pc.obs_pt)
    lam = {d: torch.full((), LAM, device=d) for d in (cpu, dev)}
    rng = np.random.default_rng(0)
    obs_keys = [k for k in fields if k.startswith("obs_")]
    for kind, step in gn_steps().items():
        ref = step(pc, lam[cpu])
        exact = step(p64, lam[cpu].double())
        for i in range(args.reps):
            g = gn_step_gaps(step(pd, lam[dev]),
                               step(pd64, lam[dev].double()), ref, exact,
                               jac, LAM)
            record(f"{kind} step, {dev.type} run {i}:", _flat(kind, g))
        for i in range(args.reorder):
            perm = rng.permutation(len(fields["obs_cam"]))
            pp = B.problem_from_numpy(
                dict(fields, **{k: fields[k][perm] for k in obs_keys}), cpu)
            got = step(pp, lam[cpu])
            record(f"{kind} step, CPU reordered {i}:", {
                f"{kind}.reordered.cpu_dc": _gap(got[0], ref[0]),
                f"{kind}.reordered.f32_f64_dc": _gap(got[0], exact[0]),
                f"{kind}.reordered.h_norm": gn_norm_gap(jac, got, exact,
                                                         LAM)})
    _, small, _ = averaging_problems()
    for i in range(args.reps):
        _, gaps = translation_gaps(small, dev)
        record(f"translation, 24 nodes, {dev.type} run {i}:",
               _flat("translation", gaps))
    summary = {k: [min(v), max(v)] for k, v in sorted(seen.items())}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
