"""Run one cell of the benchmark of popsift_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit (also the last
lines of standard error). Exits non-zero, printing no result, where no
card is found, where the program cannot be imported, or where JAX or the
JAX package was loaded.
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


def say(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import core
    from harness.spec import Cell
    cell = Cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import popsift_tpu_torch  # noqa: F401
    except ImportError as exc:
        say(f"the program is not importable here: {exc}")
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, run = core.run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), dev, T_START, say)
    found = core.banned_modules()
    if found:
        say(f"JAX or the JAX package was loaded: {found}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        say("profile summary: " + core.write_summary(
            ROOT, cell.name, args.seed, result, run))
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"],
           "device": device}
    for key in ("breakdown", "setup", "readings", "checks"):
        if key in result:
            out[key] = result[key]
    say("setup: " + json.dumps(result["setup"]))
    say("readings: " + json.dumps(result["readings"]))
    for k, c in result["checks"].items():
        say(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
