"""Restartable batch extraction jobs on a PyTorch device.

Port of :mod:`popsift_tpu.runtime.batchjob` with the device chosen
explicitly. The crash-safe parts are the JAX job's, in this package's
own copy: per-frame results written atomically as .npz, an append-only MANIFEST.jsonl whose torn last line is ignored, and
re-runs that skip every frame already in the manifest. PGM/PPM frames
decode on the native host pipeline's worker threads
(:mod:`.native`) ahead of extraction; up to ``batch``
consecutive same-shaped frames go through one ``enqueue_batch``.

:meth:`BatchExtractJob.run` mirrors ``popsift_tpu.runtime.batchjob.
BatchExtractJob.run`` line for line except for the ``PopSift``
constructor, which takes the device: a change to the resume, grouping or
manifest logic of either copy belongs in both, so that the manifests
and .npz files of the two jobs stay interchangeable.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

import numpy as np

from ..config import SiftConfig


def _atomic_write_npz(path: str, payload: dict):
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as fh:
        np.savez_compressed(fh, **payload)
    os.replace(tmp, path)


def _load_manifest(path: str) -> dict:
    """Read MANIFEST.jsonl; skip a torn (crash-truncated) last line."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue       # torn tail from a crash mid-append
            done[rec["frame"]] = rec
    return done


class _Ready:
    """A decoded image with the native pipeline's ``get`` interface."""

    def __init__(self, img):
        self._img = img

    def get(self):
        return self._img


class BatchExtractJob:
    """Extract features for many frames with crash-safe resume::

        job = BatchExtractJob(out_dir, config, device="cuda")
        stats = job.run(paths)      # resumes automatically on re-run
    """

    def __init__(self, out_dir: str, config: SiftConfig | None = None,
                 verbose: bool = False, batch: int = 1, device="cuda"):
        self.out_dir = out_dir
        self.config = config or SiftConfig()
        self.verbose = verbose
        self.batch = max(1, int(batch))
        self.device = device
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, "MANIFEST.jsonl")

    def _out_path(self, frame: str) -> str:
        stem = os.path.splitext(os.path.basename(frame))[0]
        return os.path.join(self.out_dir, f"{stem}.features.npz")

    def run(self, paths, on_frame=None) -> dict:
        """Process ``paths``; returns {"done": n, "skipped": n}.
        ``on_frame(path, features)`` is called after each completed
        frame."""
        from ..api import PopSift

        done = _load_manifest(self.manifest_path)
        ps = PopSift(self.config, device=self.device)
        try:
            from . import native
            pipeline = native.HostPipeline(threads=2)
        except ImportError:
            pipeline = None

        def decode(path):
            if pipeline is not None and path.lower().endswith(
                    (".pgm", ".ppm", ".pnm")):
                return pipeline.submit(path)
            from ..io.image import load_image
            return _Ready(load_image(path))

        pending = [p for p in paths if p not in done]
        skipped = len(paths) - len(pending)
        n_done = 0
        # decode ahead of compute in a bounded window (the native queue
        # is bounded; submitting everything could block against our own
        # consumption order)
        lookahead = max(4, 2 * self.batch)
        window = collections.deque()
        idx = 0
        manifest = open(self.manifest_path, "a")
        try:
            while idx < len(pending) or window:
                while idx < len(pending) and len(window) < lookahead:
                    window.append((pending[idx], decode(pending[idx])))
                    idx += 1
                # up to self.batch consecutive same-shaped frames as one
                # batched extraction; a shape change ends the group
                group = [(window[0][0], window.popleft()[1].get())]
                while (window and len(group) < self.batch
                       and window[0][1].get().shape == group[0][1].shape
                       and window[0][1].get().dtype == group[0][1].dtype):
                    group.append((window[0][0], window.popleft()[1].get()))
                if len(group) == 1:
                    jobs = [ps.enqueue(group[0][1])]
                else:
                    jobs = ps.enqueue_batch([im for _, im in group])
                for (path, _), job in zip(group, jobs):
                    feats = job.get()
                    out = self._out_path(path)
                    _atomic_write_npz(out, dict(
                        x=feats.x, y=feats.y, sigma=feats.sigma,
                        octave=feats.octave, num_ori=feats.num_ori,
                        orientations=feats.orientations,
                        descriptors=feats.descriptors,
                        desc_to_kp=feats.desc_to_kp))
                    rec = {"frame": path, "out": os.path.basename(out),
                           "n_kp": feats.getFeatureCount(),
                           "n_desc": feats.getDescriptorCount(),
                           "checksum": round(
                               float(np.sum(feats.descriptors)), 3)}
                    manifest.write(json.dumps(rec) + "\n")
                    manifest.flush()
                    os.fsync(manifest.fileno())
                    n_done += 1
                    if self.verbose:
                        print(f"[batch] {path}: {rec['n_kp']} kp")
                    if on_frame is not None:
                        on_frame(path, feats)
        finally:
            manifest.close()
            if pipeline is not None:
                pipeline.close()
        return {"done": n_done, "skipped": skipped}
