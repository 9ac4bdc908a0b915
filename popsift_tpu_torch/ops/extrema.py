"""DoG extrema detection and sub-pixel refinement in PyTorch.

Port of :mod:`popsift_tpu.ops.extrema` (default, dense-stack path):

* the candidate mask runs as kernel K1 (ops/kernels/extrema_mask.py),
  one launch for all octaves of a frame or batch
  (:func:`candidate_masks`); the collections take its masks ready;
* the compaction (:func:`compact_octaves`) runs as the compaction kernel
  (ops/kernels/compact.py) over the masks of all octaves and frames,
  with the counts left on the device; it keeps ``_compact_mask``'s exact
  semantics -- ascending flat order, the per-128-block cap ``K``,
  truncation at the capacity, ``n_found``, both ways of counting
  ``n_dropped`` and the padding entries -- and ``_compact_mask`` (its
  plain version, ops/kernels/compact.py) is held to JAX;
* the 5-step refinement runs as kernel K2 (ops/kernels/refine.py) on the
  dense DoG stacks, one thread per candidate row of all octaves and
  frames in one launch (:func:`refine_octaves`);
* the accept tests (:func:`finalize_refined`) run once over all octaves;
* the patch-window route (the JAX package's default on a TPU):
  :func:`window_patches` copies every candidate's [D, 11, 11] DoG
  window (kernel K6, ops/kernels/window.py; the one-octave collections
  do with ``windows=True``), and
  :func:`refine_patches` refines the merged windows of all octaves in
  one batch of plain tensor math, as JAX's ``refine_candidates`` does;
* :func:`collect_candidates`, :func:`collect_candidates_batched` and
  :func:`collect_refined_batched` are the one-octave forms (the latter
  two for F frames' stacks laid back to back on the layer axis), which
  call K2's one-octave entries; no extraction path calls them;
* :func:`detect_extrema` and :func:`collect_refined` are the JAX
  package's public one-octave names: K1's one-octave entry, the
  compaction and K2's all-octave entry on a list of one stack (which
  takes row bounds and reads no count back).

Row bands (``parallel/spatial.py``): a band's DoG stack carries halo rows
above and below the rows it owns. Its detection is the same all-octave
stages: the masks (K1, unchanged), :func:`band_masks` clearing the rows
outside the band's own (JAX's ``collect_candidates(row_window=)``,
:326-329), the compaction, :func:`refine_octaves` with each octave's
global row offset and height (K2's row bounds) and
:func:`finalize_refined` with each row's offset (``y_offset``), which
puts the refined rows in global coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SiftConfig
from ..utils.f32 import div
from .kernels.compact import (compact_mask_torch, compact_octaves as
                              _compact_kernel, compact_octaves_torch)
from .kernels.extrema_mask import (candidate_mask, candidate_mask_batched,
                                   candidate_mask_batched_torch,
                                   candidate_mask_octaves,
                                   candidate_mask_octaves_torch,
                                   candidate_mask_torch)
from .kernels.refine import (MAX_ITERATIONS, NOUT, refine_loop,
                             refine_state, refine_state_batched,
                             refine_state_batched_torch,
                             refine_state_octaves,
                             refine_state_octaves_torch, refine_state_torch)
from .kernels.window import (extract_windows, extract_windows_batched,
                             extract_windows_batched_torch,
                             extract_windows_torch)

_compact_mask = compact_mask_torch    # the compaction's plain version
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


class CandidateRows(NamedTuple):
    """Compacted candidates of all octaves of F frames, frame-major: frame
    f's octave o at rows f * Ktot + offs[o] .. + cap[o]."""

    x0: torch.Tensor         # i32[F*Ktot] column
    y0: torch.Tensor         # i32[F*Ktot] row
    z0: torch.Tensor         # i32[F*Ktot] DoG layer
    n_found: torch.Tensor    # i64[F, n_oct]
    n_dropped: torch.Tensor  # i64[F, n_oct]


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


def compact_octaves(masks, cfg: SiftConfig, caps, F: int = 1,
                    plain: bool = False) -> CandidateRows:
    """Candidate rows of the masks of all octaves of F frames (each bool
    [F, Z, H_o, W_o], :func:`candidate_masks`) at capacities ``caps``:
    the compaction kernel (or its plain version with ``plain``), nothing
    read back."""
    fn = compact_octaves_torch if plain else _compact_kernel
    return CandidateRows(*fn(list(masks), tuple(caps), cfg.compact_block_k,
                             F))


def band_masks(masks, windows) -> list:
    """The candidate masks of row bands, each octave's rows outside its
    window ``(lo, hi)`` of local rows cleared in place (None keeps the
    octave's mask): a band detects only the rows it owns."""
    for m, w in zip(masks, windows):
        if w is not None:
            m[..., :w[0], :] = False
            m[..., w[1]:, :] = False
    return list(masks)


def refine_octaves(dogs, rows: CandidateRows, cfg: SiftConfig, caps,
                   F: int = 1, plain: bool = False, y_offsets=None,
                   heights=None) -> torch.Tensor:
    """f32[F*Ktot, 16] refinement state of the candidate rows of all
    octaves of F frames (``dogs``: per octave f32[F*D, H_o, W_o]), rows
    past their octave's count zero: K2's one launch (or its plain
    version with ``plain``). For row bands ``y_offsets`` and ``heights``
    give each octave's global row of its stack's row 0 and its global
    height (K2's row bounds)."""
    fn = refine_state_octaves_torch if plain else refine_state_octaves
    return fn(list(dogs), rows.x0, rows.y0, rows.z0, rows.n_found,
              tuple(caps), F, maxlevel=cfg.total_levels - 1,
              vlfeat=cfg.sift_mode == "vlfeat", y_offsets=y_offsets,
              heights=heights)


def window_patches(dogs, rows: CandidateRows, caps, F: int = 1,
                   plain: bool = False) -> torch.Tensor:
    """The [F*Ktot, D, 11, 11] refinement windows of the candidate rows
    of all octaves (frame-major, :func:`compact_octaves`), K6 once per
    octave (or its plain version with ``plain``): its one-frame entry for
    one frame, its batched entry for several; rows past their count are
    zeros."""
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    R, P = WINDOW_RADIUS, WINDOW_SIDE
    per_octave = []
    for o, dog in enumerate(dogs):
        sl = slice(int(offs[o]), int(offs[o + 1]))
        x0 = rows.x0.view(F, -1)[:, sl].reshape(-1)
        y0 = rows.y0.view(F, -1)[:, sl].reshape(-1)
        if F == 1:
            fn = extract_windows_torch if plain else extract_windows
            p = fn(dog, y0, x0, rows.n_found[0, o], R, P, P)
        else:
            fn = extract_windows_batched_torch if plain \
                else extract_windows_batched
            p = fn(dog, y0, x0, rows.n_found[:, o], F, R, P, P)
        per_octave.append(p.view(F, caps[o], *p.shape[1:]))
    return torch.cat(per_octave, 1).flatten(0, 1)


def collect_candidates(dog: torch.Tensor, cfg: SiftConfig,
                       capacity: int, plain: bool = False,
                       windows: bool = False,
                       mask: torch.Tensor | None = None) -> CandidateSet:
    """Mask (K1) + compaction (the compaction kernel) for one octave's
    f32[D, H, W] DoG stack; ``mask`` is the octave's ready bool[Z, H, W]
    mask where the caller made all octaves' in one launch
    (:func:`candidate_masks`). The rows are i32.
    With ``windows`` also every candidate's [D, 11, 11] window (K6, or
    its plain version with ``plain``), centred on the candidate with
    edge replication, as popsift_tpu.ops.extrema.collect_candidates
    cuts them (:371-388); the count stays on the device."""
    if mask is None:
        mask = _candidate_mask(dog, cfg, plain)
    rows = compact_octaves([mask[None]], cfg, (capacity,), 1, plain)
    n_found = rows.n_found[0, 0]
    valid = torch.arange(capacity, device=dog.device) < n_found
    patches = None
    if windows:
        fn = extract_windows_torch if plain else extract_windows
        patches = fn(dog, rows.y0, rows.x0, n_found, WINDOW_RADIUS,
                     WINDOW_SIDE, WINDOW_SIDE)
    return CandidateSet(x0=rows.x0, y0=rows.y0, z0=rows.z0, valid=valid,
                        n_found=n_found, n_dropped=rows.n_dropped[0, 0],
                        patches=patches)


def collect_candidates_batched(dog: torch.Tensor, F: int, cfg: SiftConfig,
                               capacity: int, plain: bool = False,
                               windows: bool = False,
                               mask: torch.Tensor | None = None
                               ) -> CandidateSet:
    """Mask (K1's batched entry, or its plain version with ``plain``, or
    the ready bool[F, Z, H, W] ``mask`` of :func:`candidate_masks`) and
    one compaction of one octave for F frames, port of
    popsift_tpu.ops.extrema.collect_candidates_batched (:394-448) on
    dense stacks: ``dog`` is f32[F*D, H, W], frame f's D =
    total_levels-1 layers at [f*D, f*D + D). Row arrays are [F*capacity]
    frame-major with frame-local z; ``valid`` is [F, capacity] and the
    counts are [F]. With ``windows`` also the [F*capacity, D, 11, 11]
    windows (K6's batched entry), frame f's cut from its own D layers
    only (JAX's per-job layer base ``zbase``, :437-445)."""
    FD = dog.shape[0]
    if FD != F * (cfg.total_levels - 1):
        raise ValueError(f"collect_candidates_batched: {FD} layers for {F} "
                         f"frames of {cfg.total_levels - 1}")
    if mask is None:
        thr1 = float(np.float32(_first_threshold(cfg)))
        mask_fn = candidate_mask_batched_torch if plain \
            else candidate_mask_batched
        mask = _opencv_border(mask_fn(dog, F, thr1).view(torch.bool), cfg)
    # one compaction of the F frames' masks (JAX vmaps _compact_mask,
    # :518-521)
    rows = compact_octaves([mask], cfg, (capacity,), F, plain)
    n_found = rows.n_found[:, 0]
    patches = None
    if windows:
        fn = extract_windows_batched_torch if plain \
            else extract_windows_batched
        patches = fn(dog, rows.y0, rows.x0, n_found, F, WINDOW_RADIUS,
                     WINDOW_SIDE, WINDOW_SIDE)
    return CandidateSet(
        x0=rows.x0, y0=rows.y0, z0=rows.z0,
        valid=torch.arange(capacity, device=dog.device)[None, :]
        < n_found[:, None],
        n_found=n_found, n_dropped=rows.n_dropped[:, 0], patches=patches)


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
                     n_dropped, y_offset=None) -> OctaveExtrema:
    """Accept tests over refined candidates (s_extrema.cu:455-493), port
    of popsift_tpu.ops.extrema.finalize_refined (:542-601): excessive
    movement, bounds, contrast, curvature sign and edge ratio, plus sigma
    and grid cell. ``oct_w``/``oct_h`` are ints or per-row tensors, the
    counts ints or tensors; given tensors on ``state``'s device (as the
    extraction paths give them) nothing is copied from the host.
    ``y_offset`` (an int or per-row tensor) is the global row of a row
    band's local row 0: the rows, their bound test and their cells are
    then global, with ``oct_h`` the full octave height (JAX's
    ``y_offset``, :565-571)."""
    (nx, nyv, nzv, dx, dy, dz, v,
     Dx, Dy, Ds, DDx, DDy, DXy) = (state[:, i] for i in range(13))
    dev = state.device
    Wf = torch.as_tensor(oct_w, device=dev).to(torch.float32)
    Hf = torch.as_tensor(oct_h, device=dev).to(torch.float32)
    maxlevel = cfg.total_levels - 1
    thr = float(np.float32(cfg.peak_threshold))

    ok = cand_valid & ~((dx >= 1.5) | (dy >= 1.5) | (dz >= 1.5))
    xn = nx + dx
    yn = nyv + dy if y_offset is None else (nyv + y_offset) + dy
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


def _refined_octave(dog: torch.Tensor, cfg: SiftConfig, capacity: int,
                    row_window: tuple | None = None, y_offset: int = 0,
                    height: int | None = None) -> tuple:
    """(state f32[K, 16], valid bool[K], n_found, n_dropped) of one
    octave's f32[D, H, W] DoG stack: K1's one-octave entry, the rows
    outside ``row_window`` cleared (:func:`band_masks`), the compaction
    and K2's launch over the one octave, rows past ``n_found`` zero. A
    row band passes its local row 0's global row ``y_offset`` and the
    octave's global ``height`` (K2's row bounds); nothing is read
    back."""
    mask = _candidate_mask(dog, cfg)
    if row_window is not None:
        band_masks([mask], [row_window])
    rows = compact_octaves([mask[None]], cfg, (capacity,))
    H = dog.shape[1]
    height = H if height is None else int(height)
    bounded = y_offset != 0 or height != H
    state = refine_octaves([dog], rows, cfg, (capacity,),
                           y_offsets=(y_offset,) if bounded else None,
                           heights=(height,) if bounded else None)
    n_found = rows.n_found[0, 0]
    valid = torch.arange(capacity, device=dog.device) < n_found
    return state, valid, n_found, rows.n_dropped[0, 0]


def collect_refined(cfg: SiftConfig, capacity: int, dog: torch.Tensor,
                    dims: tuple) -> RefinedSet:
    """Mask + compaction + refinement of one octave, port of
    popsift_tpu.ops.extrema.collect_refined (:464-493): ``vals`` f32[K,
    16] (rows past ``n_found`` zero), ``valid`` bool[K] and the scalar
    counts. It takes the octave's dense f32[D, H, W] DoG stack where
    JAX takes its halo-padded canvas (the port has no canvases); ``dims``
    = (H, W) must be the stack's."""
    if tuple(dims) != tuple(dog.shape[1:]):
        raise ValueError(f"collect_refined: dims {tuple(dims)} are not the "
                         f"stack's {tuple(dog.shape[1:])}")
    vals, valid, n_found, n_dropped = _refined_octave(dog, cfg, capacity)
    return RefinedSet(vals=vals, valid=valid, n_found=n_found,
                      n_dropped=n_dropped)


def detect_extrema(dog: torch.Tensor, cfg: SiftConfig, capacity: int,
                   oct_w: int, oct_h: int, row_window: tuple | None = None,
                   y_offset: int = 0) -> OctaveExtrema:
    """Detect, compact, refine and accept the extrema of one octave's
    f32[D, H, W] DoG stack, port of popsift_tpu.ops.extrema.detect_extrema
    (:734-760), on the stack's device with no count read back.

    A row band with halo passes ``row_window=(lo, hi)``, the local rows
    it owns, and ``y_offset``, the global row of its local row 0 (an int
    here: it enters K2's launch table); the bound tests and the outputs
    are then global while the reads stay in the band, and ``oct_h`` is
    the full octave height."""
    y_offset = int(y_offset)
    state, valid, n_found, n_dropped = _refined_octave(
        dog, cfg, capacity, row_window, y_offset, oct_h)
    return finalize_refined(state, valid, cfg, oct_w, oct_h, n_found,
                            n_dropped, y_offset=y_offset or None)
