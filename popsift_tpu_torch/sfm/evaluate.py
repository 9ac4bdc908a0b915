"""Trajectory evaluation: ATE with Umeyama similarity alignment. Port of
:mod:`popsift_tpu.sfm.evaluate`: ``umeyama`` and ``ate_rmse`` are its
numpy code as it is; ``camera_centers`` takes its rotations from the
port's ``exp_so3`` on the CPU."""

from __future__ import annotations

import numpy as np
import torch

from .rotation import exp_so3


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Returns (s, R, t) with dst ~ s * R @ src + t. Umeyama (1991).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-20)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE) after similarity alignment."""
    s, R, t = umeyama(est_positions, gt_positions, with_scale)
    aligned = est_positions @ (s * R).T + t
    err = aligned - gt_positions
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def camera_centers(cams: np.ndarray) -> np.ndarray:
    """World-space camera centers from (rotvec, t) world->cam params
    ``cams`` [N, 6] (numpy): C = -R^T t. R is the f32 rotation, as the
    JAX package computes it."""
    w = torch.from_numpy(np.ascontiguousarray(cams[:, :3], np.float32))
    R = exp_so3(w).numpy()
    t = cams[:, 3:6]
    return -np.einsum("nij,ni->nj", R, t)
