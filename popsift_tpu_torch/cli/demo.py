"""popsift-demo for the PyTorch port: extract SIFT features from one image.

    python -m popsift_tpu_torch.cli.demo -i img.pgm -o out.txt --device cuda

Flags follow popsift_tpu.cli.demo (the reference CLI vocabulary,
main.cpp:48-149) for the options the port runs; output is the reference
text format (one line per descriptor, Feature::print,
features.cu:308-328).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="popsift-demo-torch",
        description="SIFT extraction in PyTorch/CUDA (PopSift-compatible)")
    p.add_argument("-i", "--input", required=True,
                   help="input image (PGM/PPM/...)")
    p.add_argument("-o", "--output", default="output-features.txt")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu (default cuda; "
                        "raises when no card is present)")
    p.add_argument("--octaves", type=int, default=-1)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--sigma", type=float, default=1.6)
    p.add_argument("--threshold", type=float, default=0.04)
    p.add_argument("--edge-threshold", "--edge-limit", dest="edge_limit",
                   type=float, default=10.0)
    p.add_argument("--initial-blur", type=float, default=0.5)
    p.add_argument("--vlfeat-mode", action="store_true")
    p.add_argument("--opencv-mode", action="store_true")
    p.add_argument("--classic-norm", action="store_true")
    p.add_argument("--norm-multi", type=int, default=0)
    p.add_argument("--ori-smoothing", default="vlfeat",
                   choices=("vlfeat", "opencv"))
    p.add_argument("--extrema-capacity", type=int, default=-1,
                   help="per-octave candidate capacity (-1: auto)")
    p.add_argument("--float-mode", action="store_true",
                   help="process as a [0, 1] float image (ImageFloat)")
    p.add_argument("--dont-write", action="store_true")
    p.add_argument("--write-as-uchar", action="store_true")
    p.add_argument("--print-time-info", action="store_true")
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
        initial_blur=args.initial_blur,
        assume_initial_blur=args.initial_blur > 0, sift_mode=mode,
        norm_mode="classic" if args.classic_norm else "rootsift",
        norm_multiplier=args.norm_multi, ori_smoothing=args.ori_smoothing,
        extrema_capacity=args.extrema_capacity)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from ..api import PopSift
    from ..io.image import load_image

    img = load_image(args.input)
    if args.float_mode:
        img = img.astype(np.float32) / 255.0
    ps = PopSift(config_from_args(args), device=args.device)
    t0 = time.perf_counter()
    feats = ps.enqueue(img).get()
    dt = time.perf_counter() - t0
    print(f"Number of features:    {feats.getFeatureCount()}")
    print(f"Number of descriptors: {feats.getDescriptorCount()}")
    if args.print_time_info:
        where = (torch.cuda.get_device_name(ps.device)
                 if ps.device.type == "cuda" else "cpu")
        print(f"Time: {dt * 1000:.1f} ms on {where} (first call includes "
              f"the kernel build)")
    if not args.dont_write:
        feats.save(args.output, write_as_uchar=args.write_as_uchar)
    return 0


if __name__ == "__main__":
    sys.exit(main())
