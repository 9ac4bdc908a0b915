"""Candidate compaction of all octaves and frames (csrc/compact.cu).

Replaces the per-octave ``_compact_mask`` walk of the extraction paths
(``nonzero``, ``cumsum`` and ``searchsorted`` over every octave's mask,
with the counts read back to size the next launch). The JAX package's
``_compact_mask`` (popsift_tpu/ops/extrema.py:195-282) is XLA, not a
Pallas kernel, so this kernel has no Pallas counterpart.

:func:`compact_octaves` takes the candidate masks of all octaves of F
frames (each bool or uint8 [F, Z, H_o, W_o], as K1 writes them) and
returns, on the masks' device, the frame-major candidate rows (i32 x0,
y0 and z0 = layer + 1; frame f's octave o at rows f * Ktot + offs[o] ..
+ cap[o]) and the i64 counts n_found[F, n_oct] and n_dropped[F, n_oct],
entry for entry as the plain version :func:`compact_mask_torch` (the
port's ``ops/extrema._compact_mask``) gives them per frame and octave.
On a CUDA device it is one launch (after a memset of its counters) and
reads nothing back.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import build

NAME = "compact"
SOURCE = "popsift_tpu_torch/csrc/compact.cu"
REPLACES = "popsift_tpu/ops/extrema.py:195"      # XLA, no Pallas call
MAX_OCTAVES = 16         # MAX_OCT of csrc/compact.cu
MAX_LEVELS = 4           # MAX_LEVELS of csrc/compact.cu
B = 128                  # entries a block
CTR = 4                  # counter words a segment (csrc/compact.cu CTR)
CTA_BLOCKS = 2048        # blocks a launch block counts (WARPS * CPW * CHUNK)
launches = 0


def block_k_of(n: int, capacity: int, pinned: int = 0) -> int:
    """The per-128-block clamp K of ``_compact_mask`` for a mask of ``n``
    entries: ``min(pinned, 127)``, or without a pin
    ``clip(4 cap 128 // n + 1, 16, 127)``."""
    if pinned > 0:
        return min(pinned, B - 1)
    return int(np.clip(4 * capacity * B // max(n, 1) + 1, 16, B - 1))


def levels(n: int, capacity: int) -> list:
    """Entries of each level of ``_compact_mask``'s recursion for a mask
    of ``n`` entries: level l+1 holds one bit a 128-entry block of level
    l, and the recursion stops at the first level whose blocks number at
    most max(2 cap, 512) (that level takes every block as a row)."""
    ns = [n]
    while -(-ns[-1] // B) > max(2 * capacity, 512):
        ns.append(-(-ns[-1] // B))
    return ns


def _words(n_bits: int) -> int:
    """Words of a level's bits, rounded up to whole 128-bit groups."""
    return -(-n_bits // B) * 4


@lru_cache(maxsize=64)
def _layout(shapes: tuple, caps: tuple, pinned: int, F: int):
    """The launch table (without mask addresses) and the scratch words of
    a compaction: per octave N, H*W, W, cap, K, first row, levels, scratch
    base and words a frame, and the offsets within a frame of the level
    indices and the bits of each level (csrc/compact.cu). The scratch
    starts with CTR counter words for each frame and octave; every offset
    is a whole number of 16-byte groups, which the kernel loads at once."""
    rows, base, table = 0, CTR * F * len(shapes), []
    for (Z, H, W), cap in zip(shapes, caps):
        N = Z * H * W
        ns = levels(N, cap)
        if len(ns) > MAX_LEVELS:
            raise ValueError(f"compact: a mask of {N} entries needs "
                             f"{len(ns)} levels for capacity {cap} "
                             f"(at most {MAX_LEVELS})")
        nb1 = -(-N // B)
        off_idx = 0
        off = -(-(off_idx + 2 * cap) // 4) * 4
        off_bits = []
        for n_bits in [N, nb1] + [-(-n // B) for n in ns[1:-1]]:
            off_bits.append(off)
            off += _words(n_bits)
        off_bits += [0] * (MAX_LEVELS - len(off_bits))
        table.append([0, N, H * W, W, cap, block_k_of(N, cap, pinned), rows,
                      len(ns), base, off, off_idx, *off_bits])
        base += F * off
        rows += cap
    return np.asarray(table, np.int64), base, rows


def _check(masks, caps, F: int) -> None:
    if not 1 <= len(masks) <= MAX_OCTAVES or len(caps) != len(masks):
        raise ValueError(f"compact: {len(masks)} masks for {len(caps)} "
                         f"capacities (1 to {MAX_OCTAVES} octaves)")
    for m in masks:
        if (m.dim() != 4 or m.shape[0] != F or m.numel() == 0
                or m.dtype not in (torch.bool, torch.uint8)):
            raise ValueError(f"compact: masks must be bool or uint8 "
                             f"[F={F}, Z, H, W], got {m.dtype}"
                             f"{list(m.shape)}")


def _rank_rows(m: torch.Tensor, K: int):
    """Per-row compaction of a bool[nb, B] mask: (pos i64[nb, K] lane of
    the j-th set bit, 0 past the row's count; full_cnt i64[nb])."""
    nb = m.shape[0]
    full_cnt = m.sum(1)
    r, c = m.nonzero(as_tuple=True)          # row-major, ascending
    start = torch.cumsum(full_cnt, 0) - full_cnt
    rank = torch.arange(r.numel(), device=m.device) - start[r]
    keep = rank < K
    pos = torch.zeros((nb, K), dtype=torch.long, device=m.device)
    pos[r[keep], rank[keep]] = c[keep]
    return pos, full_cnt


def compact_mask_torch(flat: torch.Tensor, capacity: int, block_k: int = 0):
    """Plain version of one segment: compact a sparse bool mask into
    ``capacity`` flat indices in ascending order, with the per-128-block
    density clamp of popsift_tpu.ops.extrema._compact_mask (:195-282),
    entry for entry -- the padding entries past the count included, with
    ``nonzero``/``cumsum``/``searchsorted`` in place of the TPU's sort
    trick. Returns (idx i64[capacity], n_found i64[], n_dropped i64[])."""
    N = flat.numel()
    K = block_k_of(N, capacity, block_k)
    nb = -(-N // B)
    dev = flat.device
    if N == nb * B and flat.is_contiguous():
        m = flat.view(nb, B)
    else:
        m = torch.zeros(nb * B, dtype=torch.bool, device=dev)
        m[:N] = flat
        m = m.view(nb, B)

    if nb <= max(2 * capacity, 512):
        # small masks: every block is a row (:242-248)
        pos, full_cnt = _rank_rows(m, K)
        cnt = full_cnt.clamp(max=K)
        dropped = (full_cnt - cnt).sum()
        bids = torch.arange(nb, device=dev)
        nsel = nb
    else:
        # large masks: rows of the first <= capacity non-empty blocks
        # (:249-267); their ids come from the same compaction one level up
        blk_cnt = m.sum(1)
        total_bits = blk_cnt.sum()
        nonempty = blk_cnt > 0
        bids, _, _ = compact_mask_torch(nonempty, capacity, block_k=B - 1)
        nsel = capacity
        live = torch.arange(capacity, device=dev) < nonempty.sum()
        pos, full_cnt = _rank_rows(m[bids] & live[:, None], K)
        cnt = full_cnt.clamp(max=K)
        dropped = total_bits - cnt.sum()

    off = torch.cumsum(cnt, 0) - cnt                # exclusive offsets
    total = torch.clamp(off[-1] + cnt[-1], max=capacity)
    s = torch.arange(capacity, device=dev)
    b = (torch.searchsorted(off, s, right=True) - 1).clamp(0, nsel - 1)
    j = (s - off[b]).clamp(0, K - 1)
    return bids[b] * B + pos[b, j], total, dropped


def compact_octaves_torch(masks, caps, pinned: int = 0, F: int = 1):
    """Plain version of :func:`compact_octaves`: :func:`compact_mask_torch`
    per frame and octave, the rows laid out as the kernel writes them."""
    _check(masks, caps, F)
    x0, y0, z0, found, dropped = [], [], [], [], []
    for f in range(F):
        for m, cap in zip(masks, caps):
            _, H, W = m.shape[1:]
            flat = m[f].reshape(-1).to(torch.bool)
            idx, n, d = compact_mask_torch(flat, cap, pinned)
            x0.append(idx % W)
            y0.append((idx % (H * W)) // W)
            z0.append(idx // (H * W) + 1)
            found.append(n)
            dropped.append(d)
    cat = lambda a: torch.cat(a).to(torch.int32)
    shape = (F, len(masks))
    return (cat(x0), cat(y0), cat(z0), torch.stack(found).view(shape),
            torch.stack(dropped).view(shape))


def compact_octaves(masks, caps, pinned: int = 0, F: int = 1):
    """Candidate rows of all octaves of F frames, (x0, y0, z0 i32[F*Ktot]
    frame-major, n_found i64[F, n_oct], n_dropped i64[F, n_oct]):
    ``masks`` bool or uint8 [F, Z, H_o, W_o] per octave, ``caps`` the
    octaves' capacities, ``pinned`` the config's ``compact_block_k``.
    Plain version on the CPU, one launch of the kernel on a CUDA device."""
    global launches
    _check(masks, caps, F)
    if masks[0].device.type == "cpu":
        return compact_octaves_torch(masks, caps, pinned, F)
    masks = [m.view(torch.uint8) if m.dtype == torch.bool else m
             for m in masks]
    build.require_cuda(NAME, *masks)
    layout, words, rows = _layout(tuple(tuple(m.shape[1:]) for m in masks),
                                  tuple(caps), pinned, F)
    table = layout.copy()
    table[:, 0] = [m.data_ptr() for m in masks]
    dev = masks[0].device
    # one allocation for the rows and the scratch, each of x0, y0, z0 and
    # the scratch from a 16-byte boundary; one for the counts
    pitch = -(-F * rows // 4) * 4
    buf = torch.empty(3 * pitch + words, dtype=torch.int32, device=dev)
    x0, y0, z0 = buf[:3 * pitch].view(3, pitch)[:, :F * rows]
    scratch = buf[3 * pitch:]
    n_found, n_dropped = torch.empty((2, F, len(masks)), dtype=torch.int64,
                                     device=dev)
    lib = build.load_library()
    build.launch(
        NAME, masks[0], lib.ps_compact_octaves,
        table.ctypes.data_as(ctypes.c_void_p), len(masks), F, rows,
        scratch.data_ptr(), x0.data_ptr(), y0.data_ptr(), z0.data_ptr(),
        n_found.data_ptr(), n_dropped.data_ptr())
    launches += 1
    return x0, y0, z0, n_found, n_dropped
