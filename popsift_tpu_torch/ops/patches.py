"""Rectangular patch extraction for the patch-fed descriptor entry.

Port of :mod:`popsift_tpu.ops.patches`: each job pulls one window of its
blur level, placed so the centre sits ``radius_y``/``radius_x`` cells
from the top-left and clamped into the image; every cell carries its
true image coordinate ``(y0 + i, x0 + j)``. Levels smaller than the
window are edge-padded first (:func:`pad_for_patches`), which equals
clamped reads. One advanced-indexing gather: this is plain tensor code
in JAX too (a vmapped ``dynamic_slice``), not a kernel.
"""

from __future__ import annotations

import torch


def pad_for_patches(img: torch.Tensor, patch: int) -> torch.Tensor:
    """Edge-pad the trailing two dims of [L, H, W] to at least ``patch``."""
    H, W = img.shape[-2:]
    if H >= patch and W >= patch:
        return img
    yi = torch.arange(max(H, patch), device=img.device).clamp(max=H - 1)
    xi = torch.arange(max(W, patch), device=img.device).clamp(max=W - 1)
    return img[..., yi[:, None], xi[None, :]]


def extract_patches(img: torch.Tensor, level: torch.Tensor,
                    cy: torch.Tensor, cx: torch.Tensor, radius: int):
    """(patches f32[K, P, P], y0, x0) with P = 2 * radius + 1: the square
    form of :func:`extract_patches_rect`, centre ``radius`` cells from
    the top-left (popsift_tpu.ops.patches.extract_patches, :35-55)."""
    P = 2 * radius + 1
    return extract_patches_rect(img, level, cy, cx, P, P, radius, radius)


def extract_patches_rect(img: torch.Tensor, level: torch.Tensor,
                         cy: torch.Tensor, cx: torch.Tensor, rows: int,
                         cols: int, radius_y: int, radius_x: int):
    """(patches f32[K, rows, cols], y0 i64[K], x0 i64[K]) of ``img``
    f32[L, H, W] with H >= rows and W >= cols: patch cell (i, j) of row k
    holds ``img[clip(level[k]), y0[k] + i, x0[k] + j]`` with
    ``y0 = clip(cy - radius_y, 0, H - rows)`` and likewise ``x0``
    (popsift_tpu.ops.patches.extract_patches_rect, :58-76)."""
    L, H, W = img.shape
    if H < rows or W < cols:
        raise ValueError(f"extract_patches_rect: level {H} x {W} smaller "
                         f"than the {rows} x {cols} window; pad it first")
    y0 = (cy.long() - radius_y).clamp(0, H - rows)
    x0 = (cx.long() - radius_x).clamp(0, W - cols)
    lv = level.long().clamp(0, L - 1)
    yy = y0[:, None] + torch.arange(rows, device=img.device)
    xx = x0[:, None] + torch.arange(cols, device=img.device)
    return img[lv[:, None, None], yy[:, :, None], xx[:, None, :]], y0, x0
