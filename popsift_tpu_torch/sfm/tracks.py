"""Track building: link pairwise feature matches into multi-view tracks.

The port's own copy of :mod:`popsift_tpu.sfm.tracks` (numpy only); its
classes and functions are held to the original's source and results
(tests/test_torch_imports.py, tests/test_torch_tracks.py).

Union-find over (image, feature) nodes — a sequential pointer-chasing
algorithm, so it runs on the host (NumPy with path compression);
everything downstream (PnP, triangulation, BA) is batched PyTorch on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Tracks:
    """Observation table: one row per (track, image, feature, uv)."""

    track_id: np.ndarray    # i64[N_obs]
    image_id: np.ndarray    # i64[N_obs]
    feature_id: np.ndarray  # i64[N_obs]
    uv: np.ndarray          # f32[N_obs, 2] pixel coordinates
    n_tracks: int

    def observations_of(self, track_ids):
        m = np.isin(self.track_id, track_ids)
        return (self.track_id[m], self.image_id[m],
                self.feature_id[m], self.uv[m])


class _UnionFind:
    def __init__(self):
        self.parent = {}
        self.size = {}

    def find(self, a):
        # iterative two-pass path compression: long match chains (video
        # sequences) would overflow Python's recursion limit otherwise
        parent = self.parent
        if a not in parent:
            parent[a] = a
            self.size[a] = 1
            return a
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:      # union by size
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def build_tracks(pair_matches: dict, keypoints: dict,
                 min_length: int = 2) -> Tracks:
    """Link matches into tracks.

    pair_matches: {(img_i, img_j): int array [M, 2]} rows of (feature in
    i, feature in j) accepted matches.
    keypoints: {img: f32 [K, 2]} pixel positions per image.
    Tracks with inconsistent observations (two features of the same
    image) are dropped, as are tracks shorter than ``min_length``.
    """
    uf = _UnionFind()
    for (i, j), m in pair_matches.items():
        for fi, fj in np.asarray(m):
            uf.union((int(i), int(fi)), (int(j), int(fj)))

    groups = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)

    tid, iid, fid, uvs = [], [], [], []
    n_tracks = 0
    for nodes in groups.values():
        imgs = [n[0] for n in nodes]
        if len(nodes) < min_length or len(set(imgs)) != len(imgs):
            continue  # short or inconsistent (multi-feature-per-image)
        for (img, feat) in sorted(nodes):
            tid.append(n_tracks)
            iid.append(img)
            fid.append(feat)
            uvs.append(keypoints[img][feat])
        n_tracks += 1

    return Tracks(
        track_id=np.asarray(tid, np.int64),
        image_id=np.asarray(iid, np.int64),
        feature_id=np.asarray(fid, np.int64),
        uv=np.asarray(uvs, np.float32).reshape(-1, 2),
        n_tracks=n_tracks,
    )
