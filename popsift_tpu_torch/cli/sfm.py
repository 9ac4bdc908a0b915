"""popsift-sfm for the PyTorch port: end-to-end structure-from-motion
over an image set.

    python -m popsift_tpu_torch.cli.sfm -i img1.pgm img2.pgm ... \\
        --fx 1200 --fy 1200 --cx 960 --cy 540 --device cuda \\
        [--retrieval 8] [--refine] [--checkpoint-dir ck]

extract -> VLAD-retrieval shortlist (optional) -> pairwise ratio-test
matching -> tracks -> seed pair -> incremental PnP registration ->
bundle adjustment (or ``--global``: rotation + translation averaging,
then robust BA), with checkpoints after every milestone. Flags, stages
and printed lines follow popsift_tpu.cli.sfm, plus ``--device`` (every
stage runs there; ``cuda`` without a card raises) and ``--seed`` (the
seed of the reconstruction's RANSAC draws).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="popsift-sfm-torch",
        description="Incremental SfM (SIFT + PnP + BA) in PyTorch/CUDA")
    p.add_argument("-i", "--images", nargs="+", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N or cpu (default cuda; "
                        "raises when no card is present)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the reconstruction's RANSAC draws")
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--min-track-length", type=int, default=2)
    p.add_argument("--ba-iters", type=int, default=10)
    p.add_argument("--global", dest="global_mode", action="store_true",
                   help="global SfM (rotation + translation averaging "
                        "over the whole view graph, then robust BA) "
                        "instead of incremental registration")
    p.add_argument("--min-covis", type=int, default=30,
                   help="min shared tracks for a view-graph edge "
                        "(--global)")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantized pairwise matching (exact integer "
                        "distances, recall >= 0.99 vs exact)")
    p.add_argument("--refine", action="store_true",
                   help="iterative refinement after reconstruction "
                        "(robust BA -> cull gross points -> "
                        "retriangulate, 2 rounds)")
    p.add_argument("--retrieval", type=int, default=0, metavar="M",
                   help="VLAD-retrieval pair shortlist: match only the "
                        "top-M most similar partners per image instead "
                        "of all O(N^2) pairs (sfm/retrieval.py)")
    p.add_argument("--ba-every", type=int, default=3,
                   help="global bundle adjustment every N registrations")
    p.add_argument("--local-ba-window", type=int, default=0, metavar="W",
                   help="windowed local BA (last W cameras + anchors) "
                        "after every registration batch; pair with a "
                        "larger --ba-every (e.g. 100). The anchors are "
                        "every registered camera outside the window "
                        "that sees a window point, so on long tracks the "
                        "anchor set, and each local BA, grows with N: "
                        "the total BA work is not O(N*W)")
    p.add_argument("--register-batch", type=int, default=1,
                   help="register up to N images per sweep")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--export", default="reconstruction.npz",
                   help="output reconstruction checkpoint")
    p.add_argument("--export-colmap", default=None, metavar="DIR",
                   help="also write a COLMAP sparse text model "
                        "(cameras/images/points3D.txt) to DIR")
    p.add_argument("--export-ply", default=None, metavar="FILE",
                   help="also write the sparse cloud + camera centers "
                        "as ASCII PLY")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def pad_to(a: np.ndarray, m: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``m`` rows."""
    out = np.zeros((m,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from ..api import PopSift
    from ..config import SiftConfig
    from ..eval.repeatability import strongest_descriptor_per_keypoint
    from ..io.image import load_image
    from ..ops.matching import match_descriptors, match_descriptors_q8
    from ..sfm.checkpoint import save_reconstruction
    from ..sfm.incremental import IncrementalSfM
    from ..sfm.tracks import build_tracks
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    imgs = [load_image(path) for path in args.images]
    n = len(imgs)
    if n < 2:
        print("need at least 2 images", file=sys.stderr)
        return 1

    fy = args.fy if args.fy is not None else args.fx
    cx = args.cx if args.cx is not None else imgs[0].shape[1] / 2.0
    cy = args.cy if args.cy is not None else imgs[0].shape[0] / 2.0
    intr = np.array([args.fx, fy, cx, cy], np.float32)

    # 1. extraction (every image queued, then each result read back)
    ps = PopSift(SiftConfig(), device=dev)
    jobs = [ps.enqueue(im) for im in imgs]
    kps, descs = {}, {}
    for i, job in enumerate(jobs):
        kp, d = strongest_descriptor_per_keypoint(job.get())
        kps[i], descs[i] = kp, d
        if args.verbose:
            print(f"image {i}: {len(kp)} keypoints")

    # 2. pairwise matching on the device, one call and one read-back a pair
    cap = max(256, 1 << (max(len(d) for d in descs.values()) - 1)
              .bit_length())
    if args.retrieval > 0:
        from ..sfm.retrieval import build_signatures, pair_shortlist
        sigs = build_signatures(descs, device=dev)
        todo = pair_shortlist(sigs, top_m=args.retrieval, device=dev)
        if args.verbose:
            print(f"retrieval shortlist: {len(todo)} of "
                  f"{n * (n - 1) // 2} pairs")
    else:
        todo = [(i, j) for i in range(n) for j in range(i + 1, n)]

    on_dev = lambda a: torch.from_numpy(a).to(dev)
    matcher = match_descriptors_q8 if args.int8 else match_descriptors
    pair_matches = {}
    for i, j in todo:
        vi = np.arange(cap) < len(descs[i])
        vj = np.arange(cap) < len(descs[j])
        res = matcher(on_dev(pad_to(descs[i], cap)), on_dev(vi),
                      on_dev(pad_to(descs[j], cap)), on_dev(vj),
                      ratio=args.ratio)
        acc = res.accept.cpu().numpy()
        rows = np.nonzero(acc)[0]
        m = np.stack([rows, res.best_idx.cpu().numpy()[rows]], axis=1)
        pair_matches[(i, j)] = m
        if args.verbose:
            print(f"pair ({i},{j}): {len(m)} matches")

    # 3. tracks + reconstruction
    tracks = build_tracks(pair_matches, kps,
                          min_length=args.min_track_length)
    print(f"tracks: {tracks.n_tracks}")
    if tracks.n_tracks < 8:
        print("too few tracks for reconstruction", file=sys.stderr)
        return 1

    if args.global_mode:
        from ..sfm.global_sfm import global_sfm
        try:
            sfm = global_sfm(tracks, intr, min_covis=args.min_covis,
                             ba_iters=args.ba_iters, seed=args.seed,
                             device=dev)
        except ValueError as e:      # sparse view graph
            print(f"global SfM failed: {e}", file=sys.stderr)
            return 1
        print(f"global SfM: {len(sfm.rec.registered)}/{n} cameras, "
              f"{len(sfm.rec.points)} points")
    else:
        sfm = IncrementalSfM(tracks, intr, seed=args.seed,
                             checkpoint_dir=args.checkpoint_dir,
                             ba_every=args.ba_every,
                             register_batch=args.register_batch,
                             local_ba_window=args.local_ba_window,
                             device=dev)
        pair = sfm.initialize()
        print(f"seed pair: {pair}, points: {len(sfm.rec.points)}")
        while (img := sfm.register_next()) is not None:
            print(f"registered image {img} "
                  f"({len(sfm.rec.points)} points)")
        costs = sfm.global_ba(iters=args.ba_iters)
        print(f"final BA cost: {float(costs[-1]):.4f} "
              f"({len(sfm.rec.registered)}/{n} cameras, "
              f"{len(sfm.rec.points)} points)")
    if args.refine and sfm.rec.registered:
        costs = sfm.refine()
        print(f"refined BA cost: {float(costs[-1]):.4f} "
              f"({len(sfm.rec.points)} points)")

    ckpt = save_reconstruction(os.path.dirname(args.export) or ".",
                               sfm.rec, tag="final")
    if os.path.abspath(ckpt) != os.path.abspath(args.export):
        shutil.copyfile(ckpt, args.export)   # the documented output path
    print(f"reconstruction written to {args.export}")
    if args.export_colmap:
        from ..sfm.export import write_colmap_text
        names = {i: os.path.basename(p)
                 for i, p in enumerate(args.images)}
        write_colmap_text(sfm.rec, args.export_colmap,
                          image_size=(imgs[0].shape[1],
                                      imgs[0].shape[0]),
                          image_names=names, tracks=tracks)
        print(f"COLMAP model written to {args.export_colmap}")
    if args.export_ply:
        from ..sfm.export import write_ply
        write_ply(sfm.rec, args.export_ply)
        print(f"PLY written to {args.export_ply}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
