"""DoG extrema detection and sub-pixel refinement in PyTorch.

Port of :mod:`popsift_tpu.ops.extrema` (default, dense-stack path):

* the candidate mask runs as kernel K1 (ops/kernels/extrema_mask.py),
  one launch for all octaves of a frame or batch
  (:func:`candidate_masks`); the collections take its masks ready;
* the compaction keeps ``_compact_mask``'s exact semantics -- ascending
  flat order, the per-128-block cap ``K``, truncation at the capacity,
  ``n_found`` and both ways of counting ``n_dropped`` -- with
  ``nonzero``/``cumsum``/``searchsorted`` in place of the TPU's sort
  trick;
* the 5-step refinement runs as kernel K2 (ops/kernels/refine.py) on the
  dense DoG stack, one thread per candidate;
* the accept tests (:func:`finalize_refined`) run once over all octaves;
* the patch-window route (the JAX package's default on a TPU): with
  ``windows=True`` the collection also copies every candidate's
  [D, 11, 11] DoG window (kernel K6, ops/kernels/window.py), and
  :func:`refine_patches` refines the merged windows of all octaves in
  one batch of plain tensor math, as JAX's ``refine_candidates`` does;
* :func:`collect_refined_batched` is the frame-batched form: one mask
  and one refine launch per octave for F frames' stacks laid back to
  back on the layer axis, the compaction per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SiftConfig
from ..utils.f32 import div
from .kernels.extrema_mask import (candidate_mask, candidate_mask_batched,
                                   candidate_mask_batched_torch,
                                   candidate_mask_octaves,
                                   candidate_mask_octaves_torch,
                                   candidate_mask_torch)
from .kernels.refine import (MAX_ITERATIONS, NOUT, refine_loop,
                             refine_state, refine_state_batched,
                             refine_state_batched_torch, refine_state_torch)
from .kernels.window import (extract_windows, extract_windows_batched,
                             extract_windows_batched_torch,
                             extract_windows_torch)

_B = 128   # compaction block width (the TPU lane count)
# refinement window: 4 moves + 1 derivative halo each side, P = 2R + 1
WINDOW_RADIUS = MAX_ITERATIONS
WINDOW_SIDE = 2 * WINDOW_RADIUS + 1


class OctaveExtrema(NamedTuple):
    """Capacity-padded refined extrema (octave coordinates)."""

    x: torch.Tensor        # f32[K] refined x
    y: torch.Tensor        # f32[K]
    s: torch.Tensor        # f32[K] continuous level
    level: torch.Tensor    # i64[K] round(s)
    sigma: torch.Tensor    # f32[K] octave-relative scale
    cell: torch.Tensor     # i64[K] grid-filter cell id
    valid: torch.Tensor    # bool[K]
    count: torch.Tensor    # i64[] number of valid entries
    n_candidates: torch.Tensor  # i64[] pre-refinement candidates
    n_dropped: torch.Tensor     # i64[] dropped by the block density clamp


class CandidateSet(NamedTuple):
    """Compacted candidates of one octave. ``patches`` is None on the
    fused route (K2 reads the DoG stack itself) and holds the refinement
    windows when the collection was asked for them."""

    x0: torch.Tensor       # i64[K] column
    y0: torch.Tensor       # i64[K] row
    z0: torch.Tensor       # i64[K] DoG layer
    valid: torch.Tensor    # bool[K] ([F, K] batched)
    n_found: torch.Tensor  # i64[] ([F] batched)
    n_dropped: torch.Tensor  # i64[] ([F] batched)
    patches: torch.Tensor | None = None   # f32[K, D, P, P], P = 11


class RefinedSet(NamedTuple):
    """Refined candidates of one octave for F frames, frame-major."""

    vals: torch.Tensor     # f32[F*K, 16] refinement state (see K2)
    valid: torch.Tensor    # bool[F, K]
    n_found: torch.Tensor  # i64[F]
    n_dropped: torch.Tensor  # i64[F]


def _first_threshold(cfg: SiftConfig) -> float:
    """First-contrast gate: popsift 1.6*thr (s_extrema.cu:253-256),
    vlfeat 0.8*2*thr == 1.6*thr (:201-204), opencv floor(thr)."""
    thr = cfg.peak_threshold
    if cfg.sift_mode in ("popsift", "vlfeat"):
        return 1.6 * thr
    return float(np.floor(thr))


def _opencv_border(mask: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """opencv's 5-pixel border rejection (s_extrema.cu:336-340) on a
    [..., H, W] mask; other modes keep the mask."""
    if cfg.sift_mode != "opencv":
        return mask
    H, W = mask.shape[-2:]
    ys = torch.arange(H, device=mask.device)
    xs = torch.arange(W, device=mask.device)
    border = ((xs < 5) | (xs >= W - 5))[None, :] \
        | ((ys < 5) | (ys >= H - 5))[:, None]
    return mask & ~border


def _candidate_mask(dog: torch.Tensor, cfg: SiftConfig,
                    plain: bool = False) -> torch.Tensor:
    """bool[Z, H, W] mask of layers z = 1 .. total_levels-3 passing the
    contrast gate and the strict 26-neighbour test (kernel K1, or its
    plain version with ``plain``), with opencv's border rejection."""
    Z = cfg.total_levels - 3
    thr1 = float(np.float32(_first_threshold(cfg)))
    fn = candidate_mask_torch if plain else candidate_mask
    return _opencv_border(
        fn(dog[:Z + 2].contiguous(), thr1).view(torch.bool), cfg)


def candidate_masks(dogs, cfg: SiftConfig, F: int = 1,
                    plain: bool = False) -> list:
    """The bool[F, Z, H_o, W_o] masks of all octaves of F frames (``dogs``:
    per octave the frames' DoG stacks back to back on the layer axis,
    f32[F*(Z+2), H_o, W_o]) in one launch of kernel K1 (or its plain
    version with ``plain``), with opencv's border rejection."""
    D = cfg.total_levels - 1
    for d in dogs:
        if d.shape[0] != F * D:
            raise ValueError(f"candidate_masks: {d.shape[0]} layers for {F} "
                             f"frames of {D}")
    thr1 = float(np.float32(_first_threshold(cfg)))
    fn = candidate_mask_octaves_torch if plain else candidate_mask_octaves
    return [_opencv_border(m, cfg) for m in fn(dogs, thr1, F)]


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


def _compact_mask(flat: torch.Tensor, capacity: int, block_k: int = 0):
    """Compact a sparse bool mask into ``capacity`` flat indices in
    ascending order, with the per-128-block density clamp of
    popsift_tpu.ops.extrema._compact_mask (:195-282), entry for entry --
    the padding entries past the count included. Returns
    (idx i64[capacity], n_found i64[], n_dropped i64[])."""
    N = flat.numel()
    if block_k > 0:
        K = min(block_k, _B - 1)
    else:
        K = int(np.clip(4 * capacity * _B // max(N, 1) + 1, 16, _B - 1))
    nb = -(-N // _B)
    dev = flat.device
    if N == nb * _B and flat.is_contiguous():
        m = flat.view(nb, _B)
    else:
        m = torch.zeros(nb * _B, dtype=torch.bool, device=dev)
        m[:N] = flat
        m = m.view(nb, _B)

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
        bids, _, _ = _compact_mask(nonempty, capacity, block_k=127)
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
    return bids[b] * _B + pos[b, j], total, dropped


def collect_candidates(dog: torch.Tensor, cfg: SiftConfig,
                       capacity: int, plain: bool = False,
                       windows: bool = False,
                       mask: torch.Tensor | None = None) -> CandidateSet:
    """Mask (K1) + compaction for one octave's f32[D, H, W] DoG stack;
    ``mask`` is the octave's ready bool[Z, H, W] mask where the caller
    made all octaves' in one launch (:func:`candidate_masks`).
    With ``windows`` also every candidate's [D, 11, 11] window (K6, or
    its plain version with ``plain``), centred on the candidate with
    edge replication, as popsift_tpu.ops.extrema.collect_candidates
    cuts them (:371-388); the count stays on the device."""
    _, H, W = dog.shape
    if mask is None:
        mask = _candidate_mask(dog, cfg, plain)
    idx, n_found, n_dropped = _compact_mask(
        mask.reshape(-1), capacity, block_k=cfg.compact_block_k)
    valid = torch.arange(capacity, device=dog.device) < n_found
    x0, y0 = idx % W, (idx % (H * W)) // W
    patches = None
    if windows:
        fn = extract_windows_torch if plain else extract_windows
        patches = fn(dog, y0, x0, n_found, WINDOW_RADIUS, WINDOW_SIDE,
                     WINDOW_SIDE)
    return CandidateSet(x0=x0, y0=y0, z0=idx // (H * W) + 1, valid=valid,
                        n_found=n_found, n_dropped=n_dropped,
                        patches=patches)


def collect_candidates_batched(dog: torch.Tensor, F: int, cfg: SiftConfig,
                               capacity: int, plain: bool = False,
                               windows: bool = False,
                               mask: torch.Tensor | None = None
                               ) -> CandidateSet:
    """Mask (K1's batched entry, or its plain version with ``plain``, or
    the ready bool[F, Z, H, W] ``mask`` of :func:`candidate_masks`) and
    per-frame compaction of one octave for F frames, port of
    popsift_tpu.ops.extrema.collect_candidates_batched (:394-448) on
    dense stacks: ``dog`` is f32[F*D, H, W], frame f's D =
    total_levels-1 layers at [f*D, f*D + D). Row arrays are [F*capacity]
    frame-major with frame-local z; ``valid`` is [F, capacity] and the
    counts are [F]. With ``windows`` also the [F*capacity, D, 11, 11]
    windows (K6's batched entry), frame f's cut from its own D layers
    only (JAX's per-job layer base ``zbase``, :437-445)."""
    FD, H, W = dog.shape
    if FD != F * (cfg.total_levels - 1):
        raise ValueError(f"collect_candidates_batched: {FD} layers for {F} "
                         f"frames of {cfg.total_levels - 1}")
    if mask is None:
        thr1 = float(np.float32(_first_threshold(cfg)))
        mask_fn = candidate_mask_batched_torch if plain \
            else candidate_mask_batched
        mask = _opencv_border(mask_fn(dog, F, thr1).view(torch.bool), cfg)
    # per-frame compaction (JAX vmaps _compact_mask, :518-521)
    comp = [_compact_mask(mask[f].reshape(-1), capacity,
                          block_k=cfg.compact_block_k) for f in range(F)]
    idx = torch.stack([c[0] for c in comp]).reshape(-1)
    n_found = torch.stack([c[1] for c in comp])
    x0, y0 = idx % W, (idx % (H * W)) // W
    patches = None
    if windows:
        fn = extract_windows_batched_torch if plain \
            else extract_windows_batched
        patches = fn(dog, y0, x0, n_found, F, WINDOW_RADIUS, WINDOW_SIDE,
                     WINDOW_SIDE)
    return CandidateSet(
        x0=x0, y0=y0, z0=idx // (H * W) + 1,
        valid=torch.arange(capacity, device=dog.device)[None, :]
        < n_found[:, None],
        n_found=n_found, n_dropped=torch.stack([c[2] for c in comp]),
        patches=patches)


def collect_refined_batched(dog: torch.Tensor, F: int, cfg: SiftConfig,
                            capacity: int, plain: bool = False,
                            mask: torch.Tensor | None = None) -> RefinedSet:
    """:func:`collect_candidates_batched`, then one refinement launch
    (K2's batched entry, or its plain version with ``plain``) for all F
    frames; port of popsift_tpu.ops.extrema.collect_refined_batched
    (:496-539). ``vals`` rows are frame-major."""
    cand = collect_candidates_batched(dog, F, cfg, capacity, plain,
                                      mask=mask)
    refine_fn = refine_state_batched_torch if plain else refine_state_batched
    vals = refine_fn(dog, cand.x0, cand.y0, cand.z0, cand.n_found, F,
                     maxlevel=cfg.total_levels - 1,
                     vlfeat=cfg.sift_mode == "vlfeat")
    return RefinedSet(vals=vals, valid=cand.valid, n_found=cand.n_found,
                      n_dropped=cand.n_dropped)


def refine_candidates(dog: torch.Tensor, cand: CandidateSet,
                      cfg: SiftConfig, plain: bool = False) -> torch.Tensor:
    """f32[K, 16] refinement state of one octave's candidates (kernel
    K2, or its plain version with ``plain``), rows past ``n_found``
    zero."""
    fn = refine_state_torch if plain else refine_state
    return fn(dog, cand.x0, cand.y0, cand.z0, int(cand.n_found),
                        maxlevel=cfg.total_levels - 1,
                        vlfeat=cfg.sift_mode == "vlfeat")


def refine_patches(patches: torch.Tensor, x0: torch.Tensor,
                   y0: torch.Tensor, z0: torch.Tensor, valid: torch.Tensor,
                   cfg: SiftConfig, oct_w, oct_h) -> torch.Tensor:
    """f32[K, 16] refinement state of K candidates from their pre-cut
    windows ``patches`` f32[K, D, P, P] (window centre = the candidate's
    start position), port of popsift_tpu.ops.extrema.refine_candidates
    (:604-731) up to the state that :func:`finalize_refined` takes. The
    rows may come from many octaves: ``oct_w``/``oct_h`` are ints or
    per-row tensors. Plain tensor math, as it is plain XLA in JAX.

    The 27 neighbours are index gathers from the window, not JAX's
    one-hot sums (:626-650, a form for the TPU's vector unit): a gather
    of one element is exact, so the values are the same. The loop is
    :func:`..kernels.refine.refine_loop`, shared with K2's plain version,
    so this route and the fused one round alike. Rows that are not
    ``valid`` are zeros, as K2 leaves them."""
    K, D, P, _ = patches.shape
    R = (P - 1) // 2
    dev = patches.device
    flat = patches.reshape(K, D * P * P)
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    W = torch.as_tensor(oct_w, device=dev).long()
    H = torch.as_tensor(oct_h, device=dev).long()
    ar3 = torch.arange(3, device=dev) - 1

    def neighbourhood(nz, ny, nx):
        zi = (nz[:, None] + ar3).clamp(0, D - 1)
        yi = (ny - y0)[:, None] + (R + ar3)
        xi = (nx - x0)[:, None] + (R + ar3)
        idx = (zi[:, :, None, None] * P + yi[:, None, :, None]) * P \
            + xi[:, None, None, :]
        return torch.gather(flat, 1, idx.reshape(K, 27)).view(K, 3, 3, 3)

    cols = refine_loop(neighbourhood, x0, y0, z0, W, H,
                       maxlevel=cfg.total_levels - 1,
                       vlfeat=cfg.sift_mode == "vlfeat")
    out = torch.zeros((K, NOUT), dtype=torch.float32, device=dev)
    out[:, :len(cols)] = torch.stack(cols, dim=1)
    return torch.where(valid.reshape(-1)[:, None], out,
                       torch.zeros_like(out))


def finalize_refined(state: torch.Tensor, cand_valid: torch.Tensor,
                     cfg: SiftConfig, oct_w, oct_h, n_candidates,
                     n_dropped) -> OctaveExtrema:
    """Accept tests over refined candidates (s_extrema.cu:455-493), port
    of popsift_tpu.ops.extrema.finalize_refined (:542-601): excessive
    movement, bounds, contrast, curvature sign and edge ratio, plus sigma
    and grid cell. ``oct_w``/``oct_h`` are ints or per-row tensors."""
    (nx, nyv, nzv, dx, dy, dz, v,
     Dx, Dy, Ds, DDx, DDy, DXy) = (state[:, i] for i in range(13))
    dev = state.device
    Wf = torch.as_tensor(oct_w, device=dev).to(torch.float32)
    Hf = torch.as_tensor(oct_h, device=dev).to(torch.float32)
    maxlevel = cfg.total_levels - 1
    thr = float(np.float32(cfg.peak_threshold))

    ok = cand_valid & ~((dx >= 1.5) | (dy >= 1.5) | (dz >= 1.5))
    xn = nx + dx
    yn = nyv + dy
    sn = nzv + dz
    ok = ok & (xn >= 0.0) & (xn <= Wf - 1.0) & (yn >= 0.0) \
        & (yn <= Hf - 1.0) & (sn >= 0.0) & (sn <= maxlevel)

    contr = v + 0.5 * (Dx * dx + Dy * dy + Ds * dz)
    tr = DDx + DDy
    det = DDx * DDy - DXy * DXy
    e = np.float32(cfg.edge_limit)
    edge_lim = float((e + np.float32(1.0)) * (e + np.float32(1.0)) / e)
    ok = ok & (det > 0.0)
    ok = ok & (contr.abs() >= 2.0 * thr)
    ok = ok & (tr * tr / torch.where(det > 0, det, torch.ones_like(det))
               < edge_lim)

    sigma = float(np.float32(cfg.sigma)) \
        * torch.exp2(div(sn, float(np.float32(cfg.levels))))
    g = cfg.filter_grid_size
    w_div = div(Wf, float(np.float32(g)))
    h_div = div(Hf, float(np.float32(g)))
    cell = (torch.floor(yn / h_div) * g + torch.floor(xn / w_div)).long()

    zf = torch.zeros_like(xn)
    zi = torch.zeros_like(cell)
    return OctaveExtrema(
        x=torch.where(ok, xn, zf),
        y=torch.where(ok, yn, zf),
        s=torch.where(ok, sn, zf),
        level=torch.where(ok, torch.round(sn).long(), zi),
        sigma=torch.where(ok, sigma, zf),
        cell=torch.where(ok, cell, zi),
        valid=ok,
        count=ok.sum(),
        n_candidates=torch.as_tensor(n_candidates, device=dev),
        n_dropped=torch.as_tensor(n_dropped, device=dev),
    )
