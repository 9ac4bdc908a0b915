"""The exact matcher's distance product and top-2 selection
(csrc/match.cu).

Replaces no Pallas kernel: the JAX package computes the matcher in XLA
(popsift_tpu/ops/matching.py:36). The plain version,
:func:`match_top2_torch`, is that computation in torch: the f32 field
``d2 = |l|^2 + |r|^2 - 2 l.r`` of each tile of ``tile`` right rows,
invalid right rows at +inf, reduced by :func:`_top2` and merged into the
running pair by :func:`_scan_tiles` (the q8 and pruned matchers of
``ops/matching.py`` share both). The kernel computes the same pairs of
the padded sets without writing the field: see the note in its source.

:func:`match_top2` runs the plain version on CPU tensors, where ``tile``
keeps its meaning, and one call of the kernel's C entry on CUDA tensors
(a launch that takes the norms and writes both sets k-major, the product
with its selection, and the merge of the parts of the right set), counted once in ``launches``; ``tile`` does not
change the CUDA result. Its bound is the matcher's: 2 x 128 f32
operations a (left, right) pair.
"""

from __future__ import annotations

import math

import torch

from ...utils.f32 import full_f32
from . import build

NAME = "match_top2"
SOURCE = "popsift_tpu_torch/csrc/match.cu"
REPLACES = "none: popsift_tpu/ops/matching.py:36 is XLA"
WIDTH = 128       # descriptor width the kernel takes
ROWS = 128        # left rows a block, right rows a tile
MAX_PARTS = 8     # most parts the right set is split into
launches = 0


def _top2(d2: torch.Tensor, big):
    """(best, its column, second, its column) of each row of ``d2``: the
    first minimal column, then that column masked to ``big`` by a
    compare and the first minimal column again (matching.py:80-87)."""
    b_d, b_i = d2.min(1)
    cols = torch.arange(d2.shape[1], device=d2.device)
    s_d, s_i = torch.where(cols == b_i[:, None], big, d2).min(1)
    return b_d, b_i, s_d, s_i


def _scan_tiles(tile_dist, n_left: int, n_right: int, tile: int, big,
                dtype, device):
    """Running (best, best index, second, second index) over the right
    set in tiles of ``tile`` columns; ``tile_dist(a, b)`` gives the
    [n_left, b - a] distances of right rows a..b with invalid rows at
    ``big``. Each tile's pair merges into the running pair by a stable
    sort of the four candidates (matching.py:90-94)."""
    fill = torch.full((n_left,), big, dtype=dtype, device=device)
    zero = torch.zeros(n_left, dtype=torch.int64, device=device)
    b_d, b_i, s_d, s_i = fill, zero, fill, zero
    for a in range(0, n_right, tile):
        t_b, t_bi, t_s, t_si = _top2(tile_dist(a, min(a + tile, n_right)),
                                     big)
        c_d, order = torch.sort(torch.stack([b_d, s_d, t_b, t_s], 1),
                                stable=True, dim=1)
        c_i = torch.stack([b_i, s_i, t_bi + a, t_si + a], 1).gather(1, order)
        b_d, s_d, b_i, s_i = c_d[:, 0], c_d[:, 1], c_i[:, 0], c_i[:, 1]
    return b_d, b_i, s_d, s_i


@full_f32()
def match_top2_torch(desc_l: torch.Tensor, desc_r: torch.Tensor,
                     valid_r: torch.Tensor, tile: int = 4096):
    """Plain version on any device: the right set in tiles of ``tile``
    rows (the last one ragged), the left set whole, products by
    ``torch.matmul`` in full f32. With no right row every left row keeps
    the carry (+inf, 0), (+inf, 0)."""
    L, R = desc_l.shape[0], desc_r.shape[0]
    l_sq = torch.sum(desc_l * desc_l, 1, keepdim=True)    # [L, 1]

    def tile_dist(a, b):
        dt = desc_r[a:b]
        d2 = l_sq + torch.sum(dt * dt, 1)[None, :] - 2.0 * (desc_l @ dt.T)
        return torch.where(valid_r[None, a:b], d2, math.inf)

    return _scan_tiles(tile_dist, L, R, max(1, min(tile, R)), math.inf,
                       torch.float32, desc_l.device)


def _tiles(n: int) -> int:
    """Tiles of ``ROWS`` rows that hold ``n`` rows."""
    return -(-n // ROWS)


def parts(n_left: int, n_right: int, n_sm: int) -> int:
    """The number of contiguous parts the right set is split into: the
    count of at most ``MAX_PARTS`` (and at most the right set's tiles)
    whose blocks fill the ``n_sm`` SMs in the fewest waves for the work
    a part, one block an SM; the smallest such count."""
    blocks = _tiles(n_left)
    best, best_cost = 1, None
    for s in range(1, min(MAX_PARTS, _tiles(n_right)) + 1):
        cost = -(-blocks * s // n_sm) / s
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def match_top2(desc_l: torch.Tensor, desc_r: torch.Tensor,
               valid_r: torch.Tensor, tile: int = 4096):
    """(best distance f32[L], best index i64[L], second distance f32[L],
    second index i64[L]) of each left row over the right rows, indices
    into the padded right set, invalid right rows never chosen. Plain
    version on the CPU, the kernel on a CUDA device; L = 0 or R = 0 make
    no launch and give the plain version's fill values."""
    global launches
    if (desc_l.dim() != 2 or desc_r.dim() != 2
            or desc_l.shape[1] != desc_r.shape[1]
            or valid_r.shape != desc_r.shape[:1]):
        raise ValueError(f"{NAME} expects [L, D] and [R, D] descriptors and "
                         f"a [R] mask")
    if desc_l.device.type == "cpu":
        return match_top2_torch(desc_l, desc_r, valid_r, tile)
    if (desc_l.dtype != torch.float32 or desc_r.dtype != torch.float32
            or desc_l.shape[1] != WIDTH):
        raise ValueError(f"{NAME}: the kernel takes f32[*, {WIDTH}] "
                         f"descriptors")
    dl, dr = desc_l.contiguous(), desc_r.contiguous()
    vr = valid_r.to(torch.bool).contiguous().view(torch.uint8)
    build.require_cuda(NAME, dl, dr, vr)
    L, R = dl.shape[0], dr.shape[0]
    dev = dl.device
    best_d = torch.empty(L, dtype=torch.float32, device=dev)
    best_i = torch.empty(L, dtype=torch.int64, device=dev)
    second_d = torch.empty(L, dtype=torch.float32, device=dev)
    second_i = torch.empty(L, dtype=torch.int64, device=dev)
    if L == 0:
        return best_d, best_i, second_d, second_i
    if R == 0:
        return (best_d.fill_(math.inf), best_i.zero_(),
                second_d.fill_(math.inf), second_i.zero_())
    S = parts(L, R, torch.cuda.get_device_properties(dev)
              .multi_processor_count)
    # both sets k-major at whole tiles, the norms, the parts' pairs
    padded = ROWS * (_tiles(L) + _tiles(R))
    scratch = torch.empty(WIDTH * padded + L + R + 4 * S * L,
                          dtype=torch.float32, device=dev)
    lib = build.load_library()
    build.launch(NAME, dl, lib.ps_match_top2, dl.data_ptr(), L,
                 dr.data_ptr(), vr.data_ptr(), R, S, scratch.data_ptr(),
                 best_d.data_ptr(), best_i.data_ptr(), second_d.data_ptr(),
                 second_i.data_ptr())
    launches += 1
    return best_d, best_i, second_d, second_i
