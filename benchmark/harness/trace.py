"""What a ``torch.profiler`` pass over a stretch of requests says.

The harness wraps the stretch in the host span ``bench/stretch`` and
each layer of a request in a span of its own (``bench/<layer>``). From
the profile this module takes the device's operations (kernels,
copies, memsets) with their times, the host's CUDA launch calls, the
spans, and the host's operations, and gives the readers of the
per-layer metrics: device time by label, device time inside a span,
the device's busy time (the union of its operations) and the stretch's
length, and for ``breakdown`` the device operations that took most time
and the device's idle gaps by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import re

# the program's kernels (csrc/*.cu), by the name of their __global__
# function, and the labels of PERF.md's kernel table
PORT_KERNELS = (
    ("blur_dog_thin_kernel", "K5 thin"),
    ("blur_dog_kernel", "K5"),
    ("blur_chain_kernel", "K7"),
    ("extrema_mask_kernel", "K1"),
    ("compact_kernel", "compaction"),
    ("refine_octaves_kernel", "K2"),
    ("refine_kernel", "K2 one-octave"),
    ("orientation_hist_kernel", "K3"),
    ("descriptor_loop_kernel", "K4"),
    ("extract_windows_kernel", "K6"),
)
PORT_LABELS = tuple(lab for _, lab in PORT_KERNELS)


def label(name: str) -> str:
    """K1-K7 and the compaction by their labels; other device operations
    by a short form of their name."""
    for fn, lab in PORT_KERNELS:
        if re.search(r"(^|::|\s)" + fn + r"\b", name):
            return f"{lab} ({fn})"
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0] + (" " + name[name.find("("):]
                                      if "(" in name else "")
    short = name.replace("(anonymous namespace)::", "").replace("void ", "")
    short = re.sub(r"[<(].*", "", short).strip()
    return short[:80] or name[:80]


class Trace:
    """The profile of one stretch of requests."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        self.device = []          # (start us, end us, label)
        self.spans = []           # (name, start us, end us)
        cpu = []                  # (start, end, name, depth)
        self.launch_times = []
        main_thread = None
        events = list(prof.events())
        for e in events:
            if e.name == "bench/stretch" and e.device_type != DeviceType.CUDA:
                main_thread = e.thread
        for e in events:
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # the spans' own marks on the device's timeline are no work
                if not e.name.startswith("bench/"):
                    self.device.append((t0, t1, label(e.name)))
                continue
            if e.thread != main_thread:
                continue
            if e.name.startswith("bench/"):
                self.spans.append((e.name[len("bench/"):], t0, t1))
            if "LaunchKernel" in e.name:
                self.launch_times.append(t0)
            depth, p = 0, e.cpu_parent
            while p is not None:
                depth, p = depth + 1, p.cpu_parent
            cpu.append((t0, t1, e.name, depth))
        stretch = [s for s in self.spans if s[0] == "stretch"]
        if not stretch:
            raise RuntimeError("the profile holds no bench/stretch span")
        self.t0, self.t1 = stretch[0][1], stretch[0][2]
        self.device.sort()
        self._cpu = sorted(cpu, key=lambda c: (c[0], -c[1]))
        self.launch_times.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _union(self):
        """Merged busy intervals of the device inside the stretch."""
        out = []
        for a, b, _ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    @property
    def launches(self) -> int:
        lo = bisect.bisect_left(self.launch_times, self.t0)
        hi = bisect.bisect_right(self.launch_times, self.t1)
        return hi - lo

    def device_s(self, labels=None, inside: str | None = None) -> float:
        """Seconds of the device operations with a label in ``labels``
        (every one if None), of those starting inside a span named
        ``inside`` if given."""
        spans = [(a, b) for n, a, b in self.spans if n == inside]
        total = 0.0
        for a, b, lab in self.device:
            if labels is not None and lab.split(" (")[0] not in labels:
                continue
            if inside is not None and not any(s <= a < e for s, e in spans):
                continue
            total += b - a
        return total * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for a, b, lab in self.device:
            by[lab] = by.get(lab, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the stretch by what the host was
        doing when each gap began: the innermost ``bench/`` span and the
        outermost host operation inside it ("python" where none was)."""
        busy = self._union()
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        by, stack, i = {}, [], 0
        for g0, g1 in gaps:
            while i < len(self._cpu) and self._cpu[i][0] <= g0:
                stack.append(self._cpu[i])
                i += 1
            stack = [c for c in stack if c[1] > g0]
            span = [c for c in stack if c[2].startswith("bench/")
                    and c[2] != "bench/stretch"]
            where = span[-1][2][len("bench/"):] if span else "between"
            inner = [c for c in stack if not c[2].startswith("bench/")
                     and (not span or c[3] > span[-1][3])]
            what = min(inner, key=lambda c: c[3])[2] if inner else "python"
            key = f"{where}: {what}"
            by[key] = by.get(key, 0.0) + (g1 - g0) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]
