#!/usr/bin/env python3
"""Where a kernel's time goes: time variants of K7 (``csrc/blur_chain.cu``)
and of the compaction (``csrc/compact.cu``) that each leave one part of the
work out, beside the source as it is, on one NVIDIA GPU.

    python3 popsift_tpu_torch/tools/kernel_ablation.py [--reps N]

Each variant is the checked-in source with one textual edit, built alone
with nvcc (the library's flags) into its own shared library and called
with the arguments the wrappers give it:

* K7 on octave 0 and octave 2 of the 1080p frame (2160 x 3840 and
  540 x 960 planes of uniform noise, the default filters, groups of
  three levels): ``as_is``; ``no_staging`` (the tile's global loads
  replaced by a constant); ``no_stores`` (the blur and DoG stores left
  out); and the source as it is with groups of two levels. ``as_is`` is
  held bit-equal to the plain version.
* The compaction of the bench frame's masks (``bench.make_frame`` seed 0,
  ``SiftConfig(extrema_capacity=8192)``) and of four frames (seeds 0-3):
  ``as_is``, held entry for entry to the plain version, and
  ``count_only`` (the select left out: the count and the tickets alone).

Device time of each launch from one ``torch.profiler`` pass over
``--reps`` calls (median). An edit whose anchor is no longer in the
source stops the script: the variants follow the source as it is. Prints
one JSON object a line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "popsift_tpu_torch", "csrc")

# (anchor, replacement) edits of each variant
K7_VARIANTS = {
    "as_is": [],
    "no_staging": [(
        "                        v[i][j] = row[clampi(tl.ox + c, 0, a.W - 1)];",
        "                        v[i][j] = (float)(r + c);")],
    "no_stores": [(
        "                    b[o] = acc[e];\n"
        "                    d[o] = acc[e] - at[e * P];",
        "                    if (acc[e] == -12345.f) b[o] = at[e * P];")],
}
COMPACT_VARIANTS = {
    "as_is": [],
    "count_only": [(
        "    select_segment(t, q, fr, ctr, q.idx_smem ? smem_idx : nullptr, "
        "f, seg,\n                   x0, y0, z0, n_found, n_dropped);",
        "")],
}


def build_variant(name: str, edits, tmp: str, build) -> ctypes.CDLL:
    with open(os.path.join(CSRC, f"{name.split(':')[0]}.cu")) as fh:
        text = fh.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"kernel_ablation: {name}: anchor not found")
        text = text.replace(old, new)
    cu = os.path.join(tmp, name.replace(":", "_") + ".cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as fh:
        fh.write(text)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    so, cu], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for fn, args in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def launch_us(fn, reps: int, key: str) -> list:
    """Device time in us of each launch of ``key`` in one pass of
    ``reps`` calls of ``fn``, as [launch 0 of a call, launch 1, ...]
    medians."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and key in e.name),
                key=lambda e: e.time_range.start)
    k = len(ev) // reps
    return [statistics.median(e.device_time for e in ev[i::k])
            for i in range(k)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    import bench
    from popsift_tpu_torch.config import SiftConfig
    from popsift_tpu_torch.gauss import build_gauss_tables, full_kernel
    from popsift_tpu_torch.ops import extrema as E
    from popsift_tpu_torch.ops.kernels import build
    from popsift_tpu_torch.ops.kernels import compact as C
    from popsift_tpu_torch.ops.kernels.blur_chain import blur_chain_torch
    from popsift_tpu_torch.ops.pyramid import build_pyramid_frames
    from popsift_tpu_torch.pipeline import build_extract_plan

    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0]}), flush=True)
    tmp = tempfile.mkdtemp()

    # K7
    cfg = SiftConfig()
    tables = build_gauss_tables(cfg)
    ks = [full_kernel(tables.inc[l], int(tables.inc_span[l]))
          for l in range(1, cfg.total_levels)]
    spans = [(k.shape[0] - 1) // 2 for k in ks]
    gen = torch.Generator().manual_seed(0)
    k7 = {n: build_variant(f"blur_chain:{n}", e, tmp, build)
          for n, e in K7_VARIANTS.items()}
    for H, W in ((2160, 3840), (540, 960)):
        src = (torch.rand((1, H, W), generator=gen) * 255).to(dev)
        want = blur_chain_torch(src, ks)
        blurs = torch.empty((1, len(ks), H, W), device=dev)
        dogs = torch.empty_like(blurs)
        runs = [(n, lib, ((0, 3), (3, 5))) for n, lib in k7.items()]
        runs.append(("as_is, groups of two", k7["as_is"],
                     ((0, 2), (2, 4), (4, 5))))
        for name, lib, groups in runs:
            def go():
                prev = src
                for g0, g1 in groups:
                    T = lib.ps_blur_chain_tile(1, H, W, sum(spans[g0:g1]))
                    taps = np.ascontiguousarray(np.concatenate(
                        [ks[i][spans[i]:] for i in range(g0, g1)]),
                        dtype=np.float32)
                    sp = np.asarray(spans[g0:g1], np.int32)
                    b, d = blurs[:, g0:g1], dogs[:, g0:g1]
                    build.check(lib.ps_blur_chain(
                        prev.data_ptr(), prev.stride(0), b.data_ptr(),
                        b.stride(0), b.stride(1), d.data_ptr(), d.stride(0),
                        d.stride(1), None, 0, 0, 0, 0, 1, H, W,
                        taps.ctypes.data, sp.ctypes.data, g1 - g0, T,
                        stream()), "blur_chain")
                    prev = blurs[:, g1 - 1]
            go()
            torch.cuda.synchronize()
            equal = bool(torch.equal(blurs, want[0])
                         and torch.equal(dogs, want[1]))
            if name.startswith("as_is") and not equal:
                raise SystemExit(f"kernel_ablation: K7 {name} differs from "
                                 f"its plain version")
            us = launch_us(go, args.reps, "blur_chain_kernel")
            print(json.dumps({"kernel": "blur_chain", "plane": [H, W],
                              "variant": name, "groups": groups,
                              "launch_us": us, "total_us": sum(us)}),
                  flush=True)

    # the compaction
    cfg = SiftConfig(extrema_capacity=8192)
    plan = build_extract_plan(cfg, 1080, 1920)
    caps = plan.ext_caps
    cl = {n: build_variant(f"compact:{n}", e, tmp, build)
          for n, e in COMPACT_VARIANTS.items()}
    for F in (1, 4):
        imgs = np.stack([bench.make_frame(1080, 1920, seed=s)
                         for s in range(F)])
        _, dogs_ = build_pyramid_frames(torch.from_numpy(imgs).to(dev),
                                        plan.pyramid)
        dogs_ = [d.view(-1, *d.shape[2:]) for d in dogs_]
        masks = (E.candidate_masks(dogs_, cfg, F) if F > 1
                 else E.candidate_masks(dogs_, cfg))
        want = C.compact_octaves_torch(masks, caps, cfg.compact_block_k, F)
        ms = [m.view(torch.uint8) for m in masks]
        layout, words, rows = C._layout(tuple(tuple(m.shape[1:]) for m in ms),
                                        tuple(caps), cfg.compact_block_k, F)
        table = layout.copy()
        table[:, 0] = [m.data_ptr() for m in ms]
        head = -(-3 * F * rows // 4) * 4
        buf = torch.empty(head + words, dtype=torch.int32, device=dev)
        x0, y0, z0 = buf[:3 * F * rows].view(3, F * rows)
        nf, nd = torch.empty((2, F, len(ms)), dtype=torch.int64, device=dev)
        for name, lib in cl.items():
            def go():
                build.check(lib.ps_compact_octaves(
                    table.ctypes.data, len(ms), F, rows,
                    buf[head:].data_ptr(), x0.data_ptr(), y0.data_ptr(),
                    z0.data_ptr(), nf.data_ptr(), nd.data_ptr(), stream()),
                    "compact")
            go()
            torch.cuda.synchronize()
            if name == "as_is" and not all(
                    torch.equal(a, b)
                    for a, b in zip((x0, y0, z0, nf, nd), want)):
                raise SystemExit("kernel_ablation: the compaction differs "
                                 "from its plain version")
            us = launch_us(go, args.reps, "compact_kernel")
            print(json.dumps({"kernel": "compact", "frames": F,
                              "variant": name, "launch_us": us}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
