"""Problems of Bundle Adjustment in the Large (BAL; Agarwal, Snavely,
Seitz and Szeliski, ECCV 2010, grail.cs.washington.edu/projects/bal).

A BAL problem file is text, whitespace-separated (a ``.bz2`` file is
read and written compressed)::

    Nc Np No
    cam pt x y          (No lines: an observation, pixels about the
    ...                  image centre)
    9 values a camera   (Nc x 9: rotvec, t, f, k1, k2)
    3 values a point    (Np x 3)

:func:`read_bal` gives its arrays, :func:`write_bal` writes them, and
:func:`problem_from_bal` makes the 9-wide :class:`ba.BAProblem` that
``ba.bundle_adjust`` solves with BAL's camera model (no camera fixed).
"""

from __future__ import annotations

import bz2

import numpy as np

from .ba import BAL_CAM_DIM, BAProblem, problem_from_numpy


def _open(path: str, mode: str):
    return bz2.open(path, mode) if str(path).endswith(".bz2") \
        else open(path, mode)


def read_bal(path: str) -> dict:
    """The arrays of a BAL problem file: ``cams`` f64[Nc, 9], ``points``
    f64[Np, 3], ``obs_cam`` and ``obs_pt`` i64[No], ``obs_uv`` f64[No, 2].
    Raises ``ValueError`` on a file whose counts or indices do not agree
    with its header."""
    with _open(path, "rb") as fh:
        tokens = fh.read().split()
    if len(tokens) < 3:
        raise ValueError(f"{path}: no BAL header")
    nc, np_, no = (int(t) for t in tokens[:3])
    want = 3 + 4 * no + BAL_CAM_DIM * nc + 3 * np_
    if len(tokens) != want:
        raise ValueError(f"{path}: {len(tokens)} values, the header "
                         f"({nc} {np_} {no}) asks for {want}")
    obs = np.array(tokens[3:3 + 4 * no], np.float64).reshape(no, 4)
    at = 3 + 4 * no
    cams = np.array(tokens[at:at + BAL_CAM_DIM * nc], np.float64).reshape(
        nc, BAL_CAM_DIM)
    points = np.array(tokens[at + BAL_CAM_DIM * nc:], np.float64).reshape(
        np_, 3)
    obs_cam, obs_pt = obs[:, 0].astype(np.int64), obs[:, 1].astype(np.int64)
    if no and (obs_cam.min() < 0 or obs_cam.max() >= nc
               or obs_pt.min() < 0 or obs_pt.max() >= np_):
        raise ValueError(f"{path}: an observation names a camera or point "
                         "outside the header's counts")
    return dict(cams=cams, points=points, obs_cam=obs_cam, obs_pt=obs_pt,
                obs_uv=obs[:, 2:])


def write_bal(path: str, fields: dict) -> None:
    """Write ``fields`` (``read_bal``'s keys) as a BAL problem file,
    every value in the 17 significant digits that round-trip a f64."""
    cams = np.asarray(fields["cams"], np.float64).reshape(-1, BAL_CAM_DIM)
    points = np.asarray(fields["points"], np.float64).reshape(-1, 3)
    uv = np.asarray(fields["obs_uv"], np.float64).reshape(-1, 2)
    cam = np.asarray(fields["obs_cam"], np.int64)
    pt = np.asarray(fields["obs_pt"], np.int64)
    lines = [f"{len(cams)} {len(points)} {len(uv)}"]
    lines += [f"{c} {p} {x!r} {y!r}" for c, p, x, y in
              zip(cam.tolist(), pt.tolist(), uv[:, 0].tolist(),
                  uv[:, 1].tolist())]
    lines += [repr(v) for v in cams.reshape(-1).tolist()]
    lines += [repr(v) for v in points.reshape(-1).tolist()]
    with _open(path, "wb") as fh:
        fh.write(("\n".join(lines) + "\n").encode())


def problem_from_bal(fields: dict, device="cuda") -> BAProblem:
    """The 9-wide :class:`ba.BAProblem` of a BAL problem's arrays on
    ``device``: f32 cameras, points and observations, every observation
    valid, no camera fixed (BAL fixes none), ``intr`` zeros (unused by
    the 9-wide model)."""
    n_cams, n_obs = len(fields["cams"]), len(fields["obs_cam"])
    return problem_from_numpy(dict(
        cams=fields["cams"], points=fields["points"],
        intr=np.zeros(4, np.float32), obs_cam=fields["obs_cam"],
        obs_pt=fields["obs_pt"], obs_uv=fields["obs_uv"],
        obs_valid=np.ones(n_obs, bool),
        cam_fixed=np.zeros(n_cams, bool)), device=device)
