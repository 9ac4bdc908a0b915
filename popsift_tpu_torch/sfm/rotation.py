"""SO(3) utilities (batched over leading axes). Port of
:mod:`popsift_tpu.sfm.rotation`."""

from __future__ import annotations

import torch

from ..utils.f32 import full_f32


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3, 3] from [..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


@full_f32()
def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation matrix [..., 3, 3] from rotation vector
    [..., 3]; first order below |w| = 1e-6."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + 1e-30)
    K = hat(w / theta[..., 0].clamp(min=1e-30))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta2 < 1e-12, eye + hat(w), R)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] from rotation matrix [..., 3, 3]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin = torch.sin(theta)
    s = torch.where(sin.abs() < 1e-7, 1.0, 2.0 * sin)
    return v * torch.where(theta[..., None] < 1e-6, 0.5,
                           (theta / s)[..., None])
