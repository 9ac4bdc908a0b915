"""The f32 spread behind two of ``chip_smoke.py``'s tolerances.

Phase 9 holds one GN step of each kind (dense, CG) on the card to the
CPU's at 100 cameras / 40,000 points, and phase 10 holds the 24-node
translation solves (dense, CG) to the CPU's and to the f64 solve. Both
systems are badly conditioned in f32, and the card's atomic sums take
another order on every run, so one comparison is one draw of the
rounding. This tool makes many draws:

  * ``--reps`` runs of each GN step on ``--device`` against the CPU's f32
    and f64 steps (``chip_smoke.gn_step_gaps``: largest entries, the
    GN model's norm, f64 against f64),
  * ``--reorder`` runs of each GN step on the CPU with the observations
    in another random order (the same sums in another order),
  * ``--reps`` runs of the 24-node solves on ``--device``
    (``chip_smoke.translation_gaps``),

prints one line a run and, last, a JSON object with the smallest and
largest value of each gap.

Usage, from the repository root (the scenes come from chip_smoke.py):

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
from popsift_tpu_torch.utils.device import resolve_device

LAM = 1e-3


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
    import chip_smoke as C

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--reorder", type=int, default=0)
    ap.add_argument("--cams", type=int, default=C.BA_CAMS)
    ap.add_argument("--points", type=int, default=C.BA_POINTS)
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

    fields = C.step_scene(args.cams, args.points)
    pc, pd = (B.problem_from_numpy(fields, d) for d in (cpu, dev))
    p64, pd64 = C.as_f64(pc), C.as_f64(pd)
    jac = (*B._jacobians(p64), pc.obs_cam, pc.obs_pt)
    lam = {d: torch.full((), LAM, device=d) for d in (cpu, dev)}
    rng = np.random.default_rng(0)
    obs_keys = [k for k in fields if k.startswith("obs_")]
    for kind, step in C.gn_steps(B).items():
        ref = step(pc, lam[cpu])
        exact = step(p64, lam[cpu].double())
        for i in range(args.reps):
            g = C.gn_step_gaps(step(pd, lam[dev]),
                               step(pd64, lam[dev].double()), ref, exact,
                               jac, LAM)
            record(f"{kind} step, {dev.type} run {i}:", _flat(kind, g))
        for i in range(args.reorder):
            perm = rng.permutation(len(fields["obs_cam"]))
            pp = B.problem_from_numpy(
                dict(fields, **{k: fields[k][perm] for k in obs_keys}), cpu)
            got = step(pp, lam[cpu])
            record(f"{kind} step, CPU reordered {i}:", {
                f"{kind}.reordered.cpu_dc": C._gap(got[0], ref[0]),
                f"{kind}.reordered.f32_f64_dc": C._gap(got[0], exact[0]),
                f"{kind}.reordered.h_norm": C.gn_norm_gap(jac, got, exact,
                                                         LAM)})
    _, small, _ = C._averaging_problems()
    for i in range(args.reps):
        _, gaps = C.translation_gaps(G, small, dev)
        record(f"translation, 24 nodes, {dev.type} run {i}:",
               _flat("translation", gaps))
    summary = {k: [min(v), max(v)] for k, v in sorted(seen.items())}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
