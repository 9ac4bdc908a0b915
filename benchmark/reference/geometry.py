"""Plain PyTorch matching and homography RANSAC: the benchmark's
reference for the pair cells.

Lowe's ratio test on squared L2 distances at 0.8 (features.cu:184-226,
223), every distance in float64; and RANSAC for a homography from given
sample ranks (4-point DLT by SVD, squared forward transfer error,
MSAC score, the lowest score wins) in float64, as
``popsift_tpu_torch/sfm/twoview.py`` documents its hypothesize-and-verify
loop. It imports nothing of the program. ``dtype=torch.bfloat16``
computes the distances in bfloat16 (the control).
"""

from __future__ import annotations

import torch

RATIO = 0.8


def ratio_matches(desc_l: torch.Tensor, desc_r: torch.Tensor,
                  ratio: float = RATIO, dtype=torch.float64,
                  rows: int = 4096):
    """(left rows, right rows) of the accepted matches, left rows
    ascending: the nearest right descriptor of each left one where the
    best squared distance is under ``ratio`` times the second best."""
    r = desc_r.to(dtype)
    r_sq = (r * r).sum(1)
    lefts, rights = [], []
    for a in range(0, desc_l.shape[0], rows):
        l = desc_l[a:a + rows].to(dtype)
        d2 = (l * l).sum(1, keepdim=True) + r_sq[None] - 2.0 * (l @ r.T)
        best, idx = torch.topk(d2.float() if dtype == torch.bfloat16 else d2,
                               min(2, d2.shape[1]), 1, largest=False)
        if best.shape[1] < 2:
            break
        ok = best[:, 0] / best[:, 1].clamp(min=1e-30) < ratio
        lefts.append(torch.nonzero(ok)[:, 0] + a)
        rights.append(idx[ok, 0])
    if not lefts:
        empty = torch.zeros(0, dtype=torch.int64)
        return empty, empty
    return torch.cat(lefts).cpu(), torch.cat(rights).cpu()


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """[S, 3, 3] homographies from [S, 4, 2] correspondences: the null
    vector of the 8 x 9 DLT system."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], -1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    A = torch.cat([r1, r2], -2)
    return torch.linalg.svd(A).Vh[..., -1, :].reshape(-1, 3, 3)


def transfer_error(H: torch.Tensor, x1: torch.Tensor,
                   x2: torch.Tensor) -> torch.Tensor:
    """[S, N] squared forward transfer errors."""
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], 1)
    p = torch.einsum("sij,nj->sni", H, h1)
    z = torch.where(p[..., 2:3].abs() < 1e-12, 1e-12, p[..., 2:3])
    return ((p[..., :2] / z - x2[None]) ** 2).sum(-1)


def ransac_homography(x1: torch.Tensor, x2: torch.Tensor,
                      ranks: torch.Tensor, thresh: float) -> torch.Tensor:
    """bool[N] inliers of the hypothesis with the lowest MSAC score among
    those of the samples ``ranks`` [S, 4] (rows of x1 / x2, [N, 2])."""
    x1, x2 = x1.double(), x2.double()
    H = homography_dlt(x1[ranks], x2[ranks])
    err = transfer_error(H, x1, x2)
    msac = err.clamp(max=thresh).sum(1)
    best = int(torch.argmin(msac))
    return err[best] < thresh
