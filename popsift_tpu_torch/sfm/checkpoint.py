"""Checkpoint / resume for reconstruction state.

The port's own copy of :mod:`popsift_tpu.sfm.checkpoint` (numpy only);
its functions are held to the original's source
(tests/test_torch_imports.py). Its relative imports reach the port's
``incremental`` driver.

The reference has no persistence or recovery — every failure path
print+exit()s (common/debug_macros.cu:36-45). For multi-hour distributed
SfM runs we persist the full reconstruction after every milestone
(seed init, each registration, each BA round) with atomic
write-then-rename, so a killed job resumes from the last milestone.

Format: a single .npz per checkpoint + a LATEST pointer file. Arrays
only — no pickle — so checkpoints are portable and safe to load.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def save_reconstruction(ckpt_dir: str, rec, tag: str = "ckpt") -> str:
    """Atomically persist a Reconstruction. Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    cam_ids = np.asarray(sorted(rec.cam_R), np.int64)
    track_ids = np.asarray(sorted(rec.points), np.int64)
    payload = {
        "intr": rec.intr,
        "cam_ids": cam_ids,
        "cam_R": np.stack([rec.cam_R[int(c)] for c in cam_ids])
        if len(cam_ids) else np.zeros((0, 3, 3), np.float32),
        "cam_t": np.stack([rec.cam_t[int(c)] for c in cam_ids])
        if len(cam_ids) else np.zeros((0, 3), np.float32),
        "track_ids": track_ids,
        "points": np.stack([rec.points[int(t)] for t in track_ids])
        if len(track_ids) else np.zeros((0, 3), np.float32),
        "registered": np.asarray(rec.registered, np.int64),
    }
    seq = 0
    while os.path.exists(os.path.join(ckpt_dir, f"rec-{seq:05d}.npz")):
        seq += 1
    path = os.path.join(ckpt_dir, f"rec-{seq:05d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as fh:
        np.savez(fh, tag=np.bytes_(tag), **payload)
    os.replace(tmp, path)

    fd, tmp = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as fh:
        fh.write(os.path.basename(path))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))
    return path


def load_reconstruction(ckpt_dir: str, path: str | None = None):
    """Load the latest (or a specific) checkpoint into a Reconstruction."""
    from .incremental import Reconstruction

    if path is None:
        with open(os.path.join(ckpt_dir, "LATEST")) as fh:
            path = os.path.join(ckpt_dir, fh.read().strip())
    with np.load(path) as z:
        rec = Reconstruction(intr=z["intr"])
        for i, c in enumerate(z["cam_ids"]):
            rec.cam_R[int(c)] = z["cam_R"][i]
            rec.cam_t[int(c)] = z["cam_t"][i]
        for i, t in enumerate(z["track_ids"]):
            rec.points[int(t)] = z["points"][i]
        rec.registered = [int(c) for c in z["registered"]]
    return rec


def resume_incremental(ckpt_dir: str, tracks, **kwargs):
    """Rebuild an IncrementalSfM around the latest checkpoint."""
    from .incremental import IncrementalSfM

    sfm = IncrementalSfM(tracks, np.zeros(4, np.float32),
                         checkpoint_dir=ckpt_dir, **kwargs)
    sfm.rec = load_reconstruction(ckpt_dir)
    return sfm
