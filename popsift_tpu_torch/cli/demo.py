"""popsift-demo for the PyTorch port: extract SIFT features from one image.

    python -m popsift_tpu_torch.cli.demo -i img.pgm -o out.txt --device cuda

Flags follow popsift_tpu.cli.demo (the reference CLI vocabulary,
main.cpp:48-149), with the same names, defaults and meanings, plus
``--device``; output is the reference text format (one line per
descriptor, Feature::print, features.cu:308-328). ``--log`` writes the
pyramid and DoG planes as PGMs to ``--log-dir``, as the JAX CLI does,
and a ``torch.profiler`` trace of the extraction beside them.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="popsift-demo-torch",
        description="SIFT extraction in PyTorch/CUDA (PopSift-compatible)")
    p.add_argument("-i", "--input", required=True,
                   help="input image (PGM/PPM/...)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu (default cuda; "
                        "raises when no card is present)")
    p.add_argument("--octaves", type=int, default=-1,
                   help="number of octaves")
    p.add_argument("--levels", type=int, default=3, help="levels per octave")
    p.add_argument("--sigma", type=float, default=1.6, help="initial sigma")
    p.add_argument("--threshold", type=float, default=0.04,
                   help="contrast threshold")
    p.add_argument("--edge-threshold", "--edge-limit", dest="edge_limit",
                   type=float, default=10.0)
    p.add_argument("--downsampling", type=float, default=-1.0,
                   help="first octave downscale exponent (-1 = 2x upscale)")
    p.add_argument("--initial-blur", type=float, default=0.5)
    p.add_argument("--gauss-mode", default="vlfeat")
    p.add_argument("--desc-mode", default="loop",
                   choices=["loop", "iloop", "grid", "igrid", "notile"])
    p.add_argument("--popsift-mode", action="store_true", default=True)
    p.add_argument("--vlfeat-mode", action="store_true")
    p.add_argument("--opencv-mode", action="store_true")
    p.add_argument("--root-sift", action="store_true", default=True)
    p.add_argument("--classic-norm", action="store_true")
    p.add_argument("--norm-multi", type=int, default=0)
    p.add_argument("--filter-max-extrema", type=int, default=-1)
    p.add_argument("--filter-grid", type=int, default=2)
    p.add_argument("--filter-sort", default="largest",
                   choices=["random", "largest", "smallest"])
    p.add_argument("--float-mode", action="store_true",
                   help="process as a [0, 1] float image (ImageFloat)")
    p.add_argument("--test-direct-scaling", "--direct-scaling",
                   dest="test_direct_scaling", action="store_true",
                   help="direct scaling mode: every octave built from "
                        "the input image (ScalingMode ScaleDirect)")
    p.add_argument("--ori-smoothing", default="vlfeat",
                   choices=("vlfeat", "opencv"),
                   help="orientation histogram smoothing variant (the "
                        "reference's compile-time WITH_VLFEAT_SMOOTHING "
                        "switch, s_orientation.cu:31-34)")
    p.add_argument("--norm-mode", default=None,
                   choices=["rootsift", "classic"],
                   help="string form of --root-sift/--classic-norm")
    p.add_argument("--pgmread-loading", action="store_true",
                   help="force the PGM/PNM codec (no PIL fallback)")
    p.add_argument("--extrema-capacity", type=int, default=-1,
                   help="per-octave candidate capacity (-1: auto)")
    p.add_argument("-o", "--output", default="output-features.txt")
    p.add_argument("--dont-write", action="store_true",
                   help="skip writing the output feature file")
    p.add_argument("--write-as-uchar", action="store_true")
    p.add_argument("--print-time-info", action="store_true",
                   help="print self host ms per span and the counters "
                        "of the run (also with -v)")
    p.add_argument("--log", action="store_true",
                   help="dump pyramid/DoG PGMs like the reference --log, "
                        "with a torch.profiler trace of the extraction")
    p.add_argument("--log-dir", default="dir-log")
    p.add_argument("--print-gauss-tables", action="store_true",
                   help="dump the Gaussian filter banks "
                        "(gauss_filter.cu:24-121)")
    p.add_argument("--print-dev-info", action="store_true",
                   help="print device capabilities (device_prop.cu:35-65)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def config_from_args(args):
    from ..config import SiftConfig
    mode = "popsift"
    if args.vlfeat_mode:
        mode = "vlfeat"
    if args.opencv_mode:
        mode = "opencv"
    return SiftConfig(
        octaves=args.octaves, levels=args.levels, sigma=args.sigma,
        threshold=args.threshold, edge_limit=args.edge_limit,
        upscale_factor=-args.downsampling, gauss_mode=args.gauss_mode,
        sift_mode=mode, desc_mode=args.desc_mode,
        norm_mode=args.norm_mode if args.norm_mode else
        ("classic" if args.classic_norm else "rootsift"),
        norm_multiplier=args.norm_multi, initial_blur=args.initial_blur,
        assume_initial_blur=args.initial_blur > 0,
        filter_max_extrema=args.filter_max_extrema,
        filter_grid_size=args.filter_grid,
        grid_filter_mode=args.filter_sort, ori_smoothing=args.ori_smoothing,
        scaling_mode="direct" if args.test_direct_scaling else "indirect",
        verbose=args.verbose, extrema_capacity=args.extrema_capacity)


def _print_gauss_tables(cfg) -> None:
    from ..gauss import build_gauss_tables
    t = build_gauss_tables(cfg)
    for name, sig, spn, fil in (("inc", t.inc_sigma, t.inc_span, t.inc),
                                ("abs_o0", t.abs_o0_sigma, t.abs_o0_span,
                                 t.abs_o0),
                                ("abs_oN", t.abs_oN_sigma, t.abs_oN_span,
                                 t.abs_oN)):
        print(f"{name}:")
        for lvl in range(cfg.total_levels):
            taps = " ".join(f"{v:.6f}" for v in fil[lvl][:int(spn[lvl])])
            print(f"  level {lvl}: sigma {float(sig[lvl]):.6f} "
                  f"span {int(spn[lvl])}: {taps}")


def _write_log(img, cfg, device, log_dir: str) -> None:
    """The pyramid and DoG planes as PGMs, named as the JAX CLI names
    them."""
    from ..io.image import write_pgm
    from ..ops.pyramid import build_pyramid
    from ..pipeline import build_extract_plan
    from ..utils.device import resolve_device
    from ..utils.profiling import to_host
    import torch
    plan = build_extract_plan(cfg, *img.shape)
    blurs, dogs = build_pyramid(torch.as_tensor(img).to(
        resolve_device(device)), plan.pyramid)
    for o, (b, d) in enumerate(zip(blurs, dogs)):
        b, d = to_host(b), to_host(d)
        for lvl in range(b.shape[0]):
            write_pgm(f"{log_dir}/pyramid-o-{o}-l-{lvl}.pgm", b[lvl])
        for lvl in range(d.shape[0]):
            write_pgm(f"{log_dir}/d-dog-o-{o}-l-{lvl}.pgm", d[lvl],
                      scaled=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import contextlib

    import numpy as np
    import torch

    from ..api import PopSift
    from ..io.image import load_image, read_pgm
    from ..utils import profiling
    from ..utils.profiling import device_trace, span

    if args.print_dev_info:
        from ..utils.device import device_report
        device_report()
    timed = args.print_time_info or args.verbose
    if timed:
        profiling.reset()
        profiling.enable_tracing(True)
    try:
        with span("load"):
            img = (read_pgm(args.input) if args.pgmread_loading
                   else load_image(args.input))
            if args.float_mode:
                img = img.astype(np.float32) / 255.0
        cfg = config_from_args(args)
        if args.print_gauss_tables:
            _print_gauss_tables(cfg)
        ps = PopSift(cfg, device=args.device)
        if args.log:
            os.makedirs(args.log_dir, exist_ok=True)
        trace = (device_trace(args.log_dir) if args.log
                 else contextlib.nullcontext())
        with trace:
            feats = ps.enqueue(img).get()
        print(f"Number of features:    {feats.getFeatureCount()}")
        print(f"Number of descriptors: {feats.getDescriptorCount()}")
        if not args.dont_write:
            with span("write"):
                feats.save(args.output, write_as_uchar=args.write_as_uchar)
    finally:
        if timed:
            profiling.enable_tracing(False)
    if args.log:
        _write_log(img, cfg, args.device, args.log_dir)
    if timed:
        where = (torch.cuda.get_device_name(ps.device)
                 if ps.device.type == "cuda" else "cpu")
        print(f"Host time on {where} (a first call includes the kernel "
              f"build):")
        print(profiling.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
