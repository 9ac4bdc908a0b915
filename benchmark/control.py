"""Readings for setting a cell's limits: the program's numbers on many
seeds beside the control's (the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's
place), in one process on one card.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \
        [--seconds 3]

Each seed runs the cell as ``run.py`` does, with a short window, then
computes the control on the frames that window served. Prints one JSON
line a seed and a summary line: the largest reading of each number over
the program's runs (the lower reading) and the smallest over the
control's (the upper reading). The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from harness import core
    from harness.spec import Cell
    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lower, upper = {}, {}
    for seed in args.seeds:
        cell = Cell(args.workload, ROOT)
        t0 = time.perf_counter()
        result, run = core.run_cell(cell, seed, args.seconds, False, dev,
                                    t0, lambda m: print(m, file=sys.stderr))
        t1 = time.perf_counter()
        sound = {k: c["value"] for k, c in result["checks"].items()}
        ctl = cell.driver.control(run.state, run.records, torch.bfloat16)
        t2 = time.perf_counter()
        for k, v in sound.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in ctl.items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "program": sound, "control": ctl,
                          "correct": result["correct"],
                          "readings": result["readings"],
                          "run_s": t1 - t0, "control_s": t2 - t1}),
              flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
