"""Reconstruction export: COLMAP text model + ASCII PLY point cloud.

The port's own copy of :mod:`popsift_tpu.sfm.export` (numpy only); its
functions are held to the original's source (tests/test_torch_imports.py)
and run on the port's reconstructions (tests/test_torch_export.py).

The reference feeds AliceVision/Meshroom; this framework's SfM results
export to the COLMAP sparse-model text format (cameras.txt, images.txt,
points3D.txt — the lingua franca consumed by COLMAP, Meshroom, nerf
pipelines, gsplat, etc.) and to PLY for quick point-cloud viewing.
Format per COLMAP's documented sparse text model:
  cameras.txt:  CAMERA_ID MODEL W H PARAMS[]        (PINHOLE fx fy cx cy)
  images.txt:   IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME + obs line
  points3D.txt: POINT3D_ID X Y Z R G B ERROR TRACK[] (IMAGE_ID POINT2D)
"""

from __future__ import annotations

import os

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def write_colmap_text(rec, out_dir: str, image_size=(0, 0),
                      image_names=None, tracks=None):
    """Write ``Reconstruction`` ``rec`` as a COLMAP sparse text model.

    image_size: (width, height) for cameras.txt; image_names maps
    image id -> file name (defaults to ``image_<id>``); ``tracks``
    (optional, a sfm.tracks.Tracks) fills the per-image observation
    lines and the point track lists — without it those are empty,
    which COLMAP accepts.
    """
    os.makedirs(out_dir, exist_ok=True)
    fx, fy, cx, cy = [float(v) for v in rec.intr]
    w, h = image_size

    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        f.write(f"1 PINHOLE {w} {h} {fx} {fy} {cx} {cy}\n")

    # observation lists per image (track id -> sequential point3D id)
    pt_id = {int(tr): k + 1 for k, tr in enumerate(sorted(rec.points))}
    obs_by_img = {}
    track_obs = {}
    if tracks is not None:
        image_id = np.asarray(tracks.image_id)
        track_id = np.asarray(tracks.track_id)
        uv = np.asarray(tracks.uv)
        for row in range(len(image_id)):
            img, tr = int(image_id[row]), int(track_id[row])
            if tr not in pt_id or img not in rec.cam_R:
                continue
            lst = obs_by_img.setdefault(img, [])
            lst.append((uv[row, 0], uv[row, 1], pt_id[tr]))
            track_obs.setdefault(tr, []).append((img, len(lst) - 1))

    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ "
                "CAMERA_ID NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for img in sorted(rec.registered):
            q = _rot_to_quat(np.asarray(rec.cam_R[img], np.float64))
            t = np.asarray(rec.cam_t[img], np.float64)
            name = (image_names or {}).get(img, f"image_{img}")
            f.write(f"{img + 1} {q[0]:.9g} {q[1]:.9g} {q[2]:.9g} "
                    f"{q[3]:.9g} {t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                    f"1 {name}\n")
            f.write(" ".join(f"{x:.3f} {y:.3f} {p}" for x, y, p in
                             obs_by_img.get(img, [])) + "\n")

    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for tr in sorted(rec.points):
            X = np.asarray(rec.points[tr], np.float64)
            track = " ".join(f"{img + 1} {k}" for img, k in
                             track_obs.get(int(tr), []))
            f.write(f"{pt_id[int(tr)]} {X[0]:.9g} {X[1]:.9g} "
                    f"{X[2]:.9g} 128 128 128 0 {track}\n")
    return out_dir


def write_ply(rec, path: str):
    """ASCII PLY of the sparse point cloud + camera centers (red)."""
    pts = [np.asarray(rec.points[tr], np.float64)
           for tr in sorted(rec.points)]
    cams = [-(np.asarray(rec.cam_R[i]).T @ np.asarray(rec.cam_t[i]))
            for i in sorted(rec.registered)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts) + len(cams)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p in pts:
            f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} 200 200 200\n")
        for c in cams:
            f.write(f"{c[0]:.6g} {c[1]:.6g} {c[2]:.6g} 255 0 0\n")
    return path
