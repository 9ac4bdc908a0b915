"""popsift-batch on a PyTorch device: restartable bulk feature extraction.

Extract features for many images into an output directory with a
crash-safe manifest; re-running the same command resumes where a killed
job stopped (runtime/batchjob.py). Port of popsift_tpu/cli/batch.py.

Usage:
    python -m popsift_tpu_torch.cli.batch -i frames/*.pgm -o features/ \\
        [--device cuda] [--batch 4]
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="popsift-batch-torch",
        description="restartable bulk SIFT extraction (PyTorch)")
    p.add_argument("-i", "--images", nargs="+", required=True)
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--octaves", type=int, default=-1)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--threshold", type=float, default=0.04)
    p.add_argument("--desc-mode", default="loop")
    p.add_argument("--batch", type=int, default=1,
                   help="extract N same-sized frames per batched run")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default), "cuda:N" or "cpu"')
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..config import SiftConfig
    from ..runtime.batchjob import BatchExtractJob

    cfg = SiftConfig(octaves=args.octaves, levels=args.levels,
                     threshold=args.threshold, desc_mode=args.desc_mode,
                     verbose=args.verbose)
    job = BatchExtractJob(args.out_dir, cfg, verbose=args.verbose,
                          batch=args.batch, device=args.device)
    stats = job.run(args.images)
    print(f"batch done: {stats['done']} extracted, "
          f"{stats['skipped']} resumed from manifest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
