"""Ports of tests/test_export.py through the port: its copy of
``sfm/export.py`` on the port's own reconstruction (the driver on the
CPU, with its own generator)."""

import numpy as np
import torch

from popsift_tpu_torch.sfm.export import (_rot_to_quat, write_colmap_text,
                                          write_ply)
from popsift_tpu_torch.sfm.incremental import IncrementalSfM
from popsift_tpu_torch.sfm.rotation import exp_so3
from popsift_tpu_torch.tools.sfm_scenes import (INTR, make_multiview,
                                                tracks_from_gt)
from test_export import _quat_to_rot

torch.set_num_threads(1)


def test_quaternion_roundtrip():
    """Port of :21-27."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        R = exp_so3(torch.from_numpy(
            rng.normal(0, 1.5, 3).astype(np.float32))).numpy().astype(
                np.float64)
        q = _rot_to_quat(R)
        np.testing.assert_allclose(_quat_to_rot(q), R, atol=1e-6)


def test_colmap_and_ply_export(tmp_path):
    """Port of :30-76."""
    rng = np.random.default_rng(7)
    n_pts, n_cams = 80, 5
    X, cams, kps = make_multiview(rng, n_pts=n_pts, n_cams=n_cams,
                                  noise=0.3)
    tracks = tracks_from_gt(kps, n_pts)
    sfm = IncrementalSfM(tracks, INTR, device="cpu")
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=6)

    out = write_colmap_text(sfm.rec, str(tmp_path / "sparse"),
                            image_size=(640, 480), tracks=tracks)
    cam_lines = [l for l in open(f"{out}/cameras.txt")
                 if not l.startswith("#")]
    assert cam_lines[0].split()[1] == "PINHOLE"
    img_lines = [l for l in open(f"{out}/images.txt")
                 if not l.startswith("#")]
    assert len(img_lines) == 2 * n_cams      # pose line + obs line
    # pose roundtrip for the first image
    first = img_lines[0].split()
    img_id = int(first[0]) - 1
    q = np.array([float(v) for v in first[1:5]])
    t = np.array([float(v) for v in first[5:8]])
    np.testing.assert_allclose(_quat_to_rot(q), sfm.rec.cam_R[img_id],
                               atol=1e-5)
    np.testing.assert_allclose(t, sfm.rec.cam_t[img_id], atol=1e-5)
    # observation line references valid point ids
    pt_lines = [l for l in open(f"{out}/points3D.txt")
                if not l.startswith("#")]
    assert len(pt_lines) == len(sfm.rec.points)
    obs = img_lines[1].split()
    assert len(obs) % 3 == 0 and len(obs) > 0
    ids = set(int(l.split()[0]) for l in pt_lines)
    assert all(int(obs[k]) in ids for k in range(2, len(obs), 3))
    # every point's track entries reference existing images
    n_img = set(int(l.split()[0]) for l in img_lines[::2])
    tr = pt_lines[0].split()[8:]
    assert all(int(tr[k]) in n_img for k in range(0, len(tr), 2))

    ply = write_ply(sfm.rec, str(tmp_path / "cloud.ply"))
    lines = open(ply).read().splitlines()
    n_vert = int([l for l in lines if l.startswith("element vertex")][0]
                 .split()[-1])
    assert n_vert == len(sfm.rec.points) + n_cams
    assert len(lines) == lines.index("end_header") + 1 + n_vert
