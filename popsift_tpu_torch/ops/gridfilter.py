"""Grid-based extrema budget filter in PyTorch.

Port of :mod:`popsift_tpu.ops.gridfilter` (the reference's Thrust
filter, s_filtergrid.cu:109-322): when the refined extrema of a frame
exceed ``filter_max_extrema`` by more than 10 % (s_orientation.cu:
362-367), the image is split into ``filter_grid_size^2`` cells and each
cell keeps its first extrema in the mode's order (largest or smallest
scale first, or a fixed pseudo-random order), up to a per-cell limit that
hands the budget sparse cells leave unused to the loaded ones
(s_filtergrid.cu:245-260).

One stable sort of a composite key (cell + the order within it) and a
segmented rank (cummax of segment starts) decide the keep-mask. Every
function takes a leading batch of frames, ``[..., n]``, and filters each
frame on its own; the over-budget test is a ``torch.where`` on the
device, so the filter reads nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SiftConfig
from .extrema import OctaveExtrema

_NO_LIMIT = 2 ** 30


def _redistributed_limit(counts: torch.Tensor, budget: int) -> torch.Tensor:
    """Per-frame keep limit, i64[...], of per-cell counts [..., n_cells]
    (s_filtergrid.cu:245-260): with the counts sorted ascending, the
    ``ct`` largest cells for which clamping every larger cell to this
    cell's count still exceeds the budget share the reduction,
    ``ceil(mean(top ct counts) - (total - budget) / ct)``; under budget
    no cell loses anything."""
    n_cells = counts.shape[-1]
    dev = counts.device
    cs = torch.sort(counts, dim=-1).values               # ascending
    prefix = torch.cumsum(cs, -1)
    total = prefix[..., -1]
    rev = torch.arange(n_cells - 1, -1, -1, device=dev)
    sumup = prefix + cs * rev               # total if clamped to cs[i]
    ct = (sumup > budget).sum(-1)
    ct_safe = ct.clamp(min=1).to(torch.float32)
    in_tail = torch.arange(n_cells, device=dev) >= (n_cells - ct)[..., None]
    tail_avg = torch.where(in_tail, cs, torch.zeros_like(cs)).sum(-1).to(
        torch.float32) / ct_safe
    excess = (total - budget).to(torch.float32)
    newlimit = torch.ceil(tail_avg - excess / ct_safe).long()
    return torch.where(ct > 0, newlimit.clamp(min=1),
                       torch.full_like(newlimit, _NO_LIMIT))


def _secondary_key(sigma: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """The order within a cell: -sigma (largest scale first), sigma, or
    the JAX package's fixed hash of the row index, uint32 arithmetic
    done in int64 masked to 32 bits, then rounded to f32."""
    if cfg.grid_filter_mode == "largest":
        return -sigma
    if cfg.grid_filter_mode == "smallest":
        return sigma
    n = sigma.shape[-1]
    h = (torch.arange(n, dtype=torch.int64, device=sigma.device)
         * 2654435761) & 0xFFFFFFFF
    h = h ^ 0x9E3779B9
    return h.to(torch.float32).expand_as(sigma)


def grid_filter_mask(cell: torch.Tensor, sigma: torch.Tensor,
                     valid: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """The keep-mask, bool[..., n], that leaves at most the redistributed
    limit of valid extrema in each grid cell of each frame
    (popsift_tpu.ops.gridfilter.grid_filter_mask). ``cell``, ``sigma``
    (in input-image units, so that octaves compare) and ``valid`` are
    [..., n]: the rows of all octaves of a frame."""
    n = cell.shape[-1]
    dev = cell.device
    n_cells = cfg.filter_grid_size * cfg.filter_grid_size
    onehot = cell[..., None] == torch.arange(n_cells, device=dev)
    counts = (valid[..., None] & onehot).sum(-2)
    limit = _redistributed_limit(counts, cfg.filter_max_extrema)

    sec = _secondary_key(sigma, cfg)
    inf = torch.full_like(sec, float("inf"))
    smin = torch.where(valid, sec, inf).amin(-1, keepdim=True)
    smax = torch.where(valid, sec, -inf).amax(-1, keepdim=True)
    rng = (smax - smin).clamp(min=1e-20)
    frac = ((sec - smin) / rng).clamp(0.0, 1.0) * 0.999
    key = torch.where(valid, cell.to(torch.float32) + frac,
                      torch.full_like(frac, float(np.float32(n_cells + 2))))
    order = torch.sort(key, dim=-1, stable=True).indices

    sc = torch.gather(cell, -1, order)
    sv = torch.gather(valid, -1, order)
    first = torch.ones_like(sv)
    first[..., 1:] = sc[..., 1:] != sc[..., :-1]
    idx = torch.arange(n, device=dev).expand_as(order)
    seg_start = torch.cummax(torch.where(first, idx, torch.full_like(idx, -1)),
                             dim=-1).values
    keep_sorted = sv & (idx - seg_start < limit[..., None])
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def maybe_grid_filter(cell: torch.Tensor, sigma: torch.Tensor,
                      valid: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """The filtered validity of each frame that holds more than 1.1 x
    ``filter_max_extrema`` valid rows, the validity as it was of every
    other (s_orientation.cu:362-367); both computed, one chosen on the
    device."""
    total = valid.sum(-1, keepdim=True).to(torch.float32)
    over = total > float(np.float32(1.1 * cfg.filter_max_extrema))
    return torch.where(over, grid_filter_mask(cell, sigma, valid, cfg),
                       valid)


def apply_grid_filter(ext: OctaveExtrema, cfg: SiftConfig) -> OctaveExtrema:
    """One octave's extrema under the filter (a budget for that octave
    alone), as popsift_tpu.ops.gridfilter.apply_grid_filter."""
    new_valid = maybe_grid_filter(ext.cell, ext.sigma, ext.valid, cfg)
    return ext._replace(valid=new_valid, count=new_valid.sum())
