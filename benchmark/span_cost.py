"""What the program's spans and counters cost, off and on.

    python3 benchmark/span_cost.py

Off: ns a span call while tracing is off (``with span(...)`` over a
million calls, less the empty loop), on the host of the run. On the
card: ``video1080_stream``'s untraced request loop in 8 blocks of 200
frames, tracing off and on (``enable_tracing``) by turns (off, on, on,
off, ...), host ms a frame of each block after a synchronize; and the
spans a frame. Prints one JSON object. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

WORKLOAD, SEED, FRAMES, BLOCKS = "video1080_stream", 1, 200, 8


def off_ns(calls: int = 1_000_000) -> float:
    """ns a ``with span(...)`` costs while tracing is off."""
    from popsift_tpu_torch.utils.profiling import span, tracing
    assert not tracing()

    def spans():
        for _ in range(calls):
            with span("front"):
                pass

    def empty():
        for _ in range(calls):
            pass
    best = {}
    for fn in (empty, spans) * 3:
        t = time.perf_counter_ns()
        fn()
        ns = (time.perf_counter_ns() - t) / calls
        best[fn.__name__] = min(best.get(fn.__name__, ns), ns)
    return best["spans"] - best["empty"]


def main() -> int:
    import torch

    from harness import core
    from harness.spec import Cell
    from popsift_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(dev),
           "off_ns_a_span": off_ns()}
    cell = Cell(WORKLOAD, ROOT)
    drv = cell.driver
    state = drv.prepare(core.ctx_for(cell, SEED, dev), {})
    profiling.reset()
    profiling.enable_tracing(True)
    units, _ = drv.request(state, 0, False)
    profiling.enable_tracing(False)
    out["spans_a_unit"] = len(profiling.spans()) / units
    out["counters_a_unit"] = {k: v / units
                              for k, v in profiling.counters().items()}
    blocks = {False: [], True: []}
    i = 0
    for b in range(BLOCKS):
        on = b % 4 in (1, 2)
        profiling.reset()
        profiling.enable_tracing(on)
        torch.cuda.synchronize(dev)
        t, n = time.perf_counter(), 0
        while n < FRAMES:
            units, _ = drv.request(state, i, False)
            n, i = n + units, i + 1
        torch.cuda.synchronize(dev)
        blocks[on].append((time.perf_counter() - t) / n * 1e3)
        profiling.enable_tracing(False)
    off, on = statistics.median(blocks[False]), statistics.median(blocks[True])
    out.update(ms_a_unit_off=blocks[False], ms_a_unit_on=blocks[True],
               median_off=off, median_on=on, on_less_off_ms=on - off)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
