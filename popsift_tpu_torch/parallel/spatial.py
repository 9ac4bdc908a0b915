"""Spatial sharding: one large frame split across the ranks of a mesh axis
by rows, with halo exchange (port of :mod:`popsift_tpu.parallel.spatial`).

Each rank holds a contiguous band of rows. Every separable blur trades
the halo rows it needs with the neighbouring ranks (:func:`_exchange_halo`,
two cyclic :func:`..mesh.ppermute`; the global top and bottom replicate
their edge rows) and runs kernel K5 on the halo'd band
(:func:`_sharded_blur`), so the band's rows equal the single-device
pyramid's bit for bit.

:func:`make_sharded_extract_fn` runs the whole extraction that way, on
the port's all-octave stages and kernels:

1. octave 0 level 0 of the band from the input band, with the input rows
   above and below from the neighbours (``ops/pyramid.py``);
2. the levels and DoG layers of each sharded octave by K5 on halo'd
   bands; the next octave's level 0 picks every second row and column of
   the band (band heights are even, so the picks are the global even
   rows);
3. octaves whose band would be thinner than the keypoint halo run
   replicated on every rank (:func:`shardable_octaves`), from the
   gathered seed level, through the single-device pyramid code;
4. detection over all octaves at once: the masks (K1) of DoG bands with
   a halo of ``hd`` rows, the rows outside each band's own cleared, the
   compaction, the refinement (K2 with each band's global row offset and
   the octave's height) and the accept tests in global rows;
5. the per-band extrema are gathered and the grid filter runs on the
   whole frame's (replicated);
6. orientation (K3) and descriptors (K4) of each rank's keypoints on blur
   bands with a halo of ``hk`` rows, the keypoints in global coordinates
   and each band's global row offset and scan rows given to the kernels;
   the per-band results are gathered into the layout of JAX's sharded
   extraction.

Ranks are processes (``parallel/launch.py::spawn`` or
``utils.device.init_distributed``); a function returned here takes this
rank's band and returns the whole frame's features on every rank. The
collectives it runs are counted in ``fn.traffic``.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import SiftConfig
from ..gauss import build_gauss_tables, full_kernel
from ..ops import descriptors as _desc
from ..ops import extrema as _ext
from ..ops import orientation as _ori
from ..ops.gridfilter import maybe_grid_filter
from ..ops.kernels.blur_dog import blur_dog, pick_every_second
from ..ops.pyramid import _octave0_level0, build_pyramid_from, polyphase0
from ..pipeline import SiftFeatures, _frames_tensor, build_extract_plan
from .mesh import Mesh, all_gather, axis_index, axis_size, ppermute, psum

HD = 6     # detection halo: the refinement's 4 moves + the mask stencil


def _count(traffic, kind: str, t: torch.Tensor, calls: int = 1) -> None:
    if traffic is not None:
        traffic[kind] += calls
        traffic[f"{kind}_bytes"] += calls * t.numel() * t.element_size()


def _exchange_halo(x: torch.Tensor, halo: int, mesh: Mesh, axis_name: str,
                   traffic=None) -> torch.Tensor:
    """``halo`` rows from each row-band neighbour around the band ``x``
    [..., Hb, W] -> [..., Hb + 2 halo, W]; the global top and bottom
    replicate their edge rows (JAX's ``_exchange_halo``: two cyclic
    ``ppermute``, every rank of the axis sending and receiving)."""
    if halo == 0:
        return x
    n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    if x.shape[-2] < halo:
        raise ValueError(f"band of {x.shape[-2]} rows under the halo {halo}")
    down = [(i, (i + 1) % n) for i in range(n)]     # send my rows downward
    up = [(i, (i - 1) % n) for i in range(n)]
    last, first = x[..., -halo:, :], x[..., :halo, :]
    from_above = ppermute(last, mesh, down, axis_name)
    from_below = ppermute(first, mesh, up, axis_name)
    if n > 1:
        _count(traffic, "exchange", last, 2)
    edge = list(x.shape)
    edge[-2] = halo
    top = x[..., :1, :].expand(edge) if me == 0 else from_above
    bot = x[..., -1:, :].expand(edge) if me == n - 1 else from_below
    return torch.cat([top, x, bot], dim=-2)


def _sharded_blur(x: torch.Tensor, kernel: np.ndarray, mesh: Mesh,
                  axis_name: str, traffic=None) -> tuple:
    """(blur, blur - x) of a row band ``x`` f32[Hb, W]: K5 (its plain
    version on the CPU) on the band with ``pad`` halo rows a side, whose
    output rows ``[pad, pad + Hb)`` are the single-device rows, since K5
    reads within its plane only."""
    pad = (kernel.shape[0] - 1) // 2
    hb = x.shape[-2]
    blur, dog = blur_dog(_exchange_halo(x, pad, mesh, axis_name,
                                        traffic)[None], kernel)
    return blur[0, pad:pad + hb], dog[0, pad:pad + hb]


def make_sharded_pyramid_fn(cfg: SiftConfig, height: int, width: int,
                            mesh: Mesh, axis_name: str = "sp"):
    """fn: this rank's rows of octave 0's level 0, f32[H/n, W] -> (blur
    levels f32[L, H/n, W], DoG layers f32[L-1, H/n, W]) of the same rows,
    by incremental blurs with halo exchange. ``height`` must divide by
    the axis size n, and a band must hold the widest blur halo."""
    tables = build_gauss_tables(cfg)
    kernels = tuple(full_kernel(tables.inc[lvl], int(tables.inc_span[lvl]))
                    for lvl in range(cfg.total_levels))
    n = axis_size(mesh, axis_name)
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh {n}")
    max_halo = max((k.shape[0] - 1) // 2 for k in kernels[1:])
    if height // n < max_halo:
        raise ValueError(
            f"row band {height // n} smaller than the largest blur halo "
            f"{max_halo}; use fewer shards for this frame size")

    def fn(lvl0: torch.Tensor):
        if tuple(lvl0.shape) != (height // n, width):
            raise ValueError(f"band {tuple(lvl0.shape)}, expected "
                             f"{(height // n, width)}")
        levels, dogs = [lvl0.to(mesh.device, torch.float32)], []
        for kernel in kernels[1:]:
            blur, dog = _sharded_blur(levels[-1], kernel, mesh, axis_name)
            levels.append(blur)
            dogs.append(dog)
        return torch.stack(levels), torch.stack(dogs)

    return fn


def shardable_octaves(plan, n: int, min_band: int) -> int:
    """Number of leading octaves whose rows divide by ``n`` and whose band
    can host the keypoint-stage halos. An octave that seeds the next one
    also needs an even band, so that per-band picks are the global even
    rows."""
    dims = plan.pyramid.dims
    S = 0
    for o, (oh, _) in enumerate(dims):
        if oh % n or (oh // n) < min_band:
            break
        if o < len(dims) - 1 and (oh // n) % 2:
            break      # cannot seed octave o+1 from an odd band
        S += 1
    return S


def _pack(floats, ints) -> torch.Tensor:
    """int32 [K, c]: the bits of f32 columns, then integer and bool
    columns, so that one collective moves many fields."""
    K = (floats or ints)[0].shape[0]
    cols = [f.to(torch.float32).reshape(K, -1).view(torch.int32)
            for f in floats]
    cols += [i.to(torch.int32).reshape(K, -1) for i in ints]
    return torch.cat(cols, 1)


def _unpack(packed: torch.Tensor, widths: tuple) -> list:
    """The columns of :func:`_pack` as int32 [K, w] blocks, in order."""
    out, c = [], 0
    for w in widths:
        out.append(packed[:, c:c + w])
        c += w
    return out


def _as_f32(cols: torch.Tensor) -> torch.Tensor:
    return cols.contiguous().view(torch.float32)


class _Layout:
    """The static layout of a sharded extraction on one rank: per octave
    its rows on this rank (``caps``, ``jcaps``: the band's share of a
    sharded octave, all of a replicated one), the band geometry, and the
    index tensors that put gathered rows where JAX's sharded extraction
    puts them (per octave o < S the n ranks' shares back to back, then
    each replicated octave)."""

    def __init__(self, plan, n: int, me: int, S: int, hk: int):
        dims = plan.pyramid.dims
        n_oct = len(dims)
        self.S = S
        self.band = [dims[o][0] // n for o in range(S)]
        caps_dev = [-(-plan.ext_caps[o] // n) for o in range(S)]
        jcaps_dev = [c + c // 4 for c in caps_dev]
        self.caps = tuple(caps_dev + list(plan.ext_caps[S:]))
        self.jcaps = tuple(jcaps_dev + list(plan.job_caps[S:]))
        self.eff_caps = tuple(caps_dev[o] * n if o < S else plan.ext_caps[o]
                              for o in range(n_oct))
        self.k_sharded = sum(caps_dev)
        self.j_sharded = sum(jcaps_dev)
        # global row of local row 0: detection bands (halo HD), keypoint
        # bands (halo hk); 0 for a replicated octave
        r0 = [me * hb for hb in self.band]
        self.det_offset = [r - HD for r in r0] + [0] * (n_oct - S)
        self.kp_offset = [r - hk for r in r0] + [0] * (n_oct - S)
        self.heights = [h for h, _ in dims]
        self.windows = [(HD, HD + hb) for hb in self.band] + \
            [None] * (n_oct - S)
        self.kp_bounds = [(1, h - 2) for h in self.heights]

        caps, eff = np.asarray(self.caps), np.asarray(self.eff_caps)
        jcaps = np.asarray(self.jcaps)
        octave = np.repeat(np.arange(n_oct), caps)
        first = np.cumsum(caps) - caps
        eff_first = np.cumsum(eff) - eff
        j_octave = np.repeat(np.arange(n_oct), jcaps)
        own = np.where(octave < S, me, 0) * caps[octave]
        self._np = dict(
            w_row=np.asarray(dims, np.int64)[octave, 1],
            h_row=np.asarray(dims, np.int64)[octave, 0],
            local_row=np.arange(caps.sum()) - first[octave],
            segment=octave,
            det_offset=np.asarray(self.det_offset, np.int64)[octave],
            # this rank's rows -> rows of the assembled frame
            own=eff_first[octave] + own + np.arange(caps.sum())
            - first[octave],
            # the assembled frame's rows -> rows of [gathered | local]
            kp_from=self._assembly(caps, S, n, self.k_sharded),
            job_from=self._assembly(jcaps, S, n, self.j_sharded),
            job_kp_offset=(eff_first[j_octave]
                           + np.where(j_octave < S, me, 0)
                           * caps[j_octave]),
            job_y_offset=np.asarray(self.kp_offset,
                                    np.float32)[j_octave],
            eff_octave=np.repeat(np.arange(n_oct), eff),
            eff_scale=np.exp2(np.repeat(np.arange(n_oct), eff).astype(
                np.float32) - np.float32(plan.config.upscale_factor)
            ).astype(np.float32))
        self._dev = {}

    @staticmethod
    def _assembly(caps, S: int, n: int, sharded: int) -> np.ndarray:
        """Per row of the assembled frame its row in [the n ranks' sharded
        rows, rank-major (n * sharded) | this rank's replicated rows]."""
        first = np.cumsum(caps) - caps
        parts = []
        for o, cap in enumerate(caps):
            if o < S:
                parts += [r * sharded + first[o] + np.arange(cap)
                          for r in range(n)]
            else:
                parts.append(n * sharded + first[o] - sharded
                             + np.arange(cap))
        return np.concatenate(parts).astype(np.int64)

    def const(self, dev: torch.device) -> dict:
        """The index and constant tensors on ``dev``, copied once."""
        if dev not in self._dev:
            self._dev[dev] = {k: torch.as_tensor(v, device=dev)
                              for k, v in self._np.items()}
        return self._dev[dev]


class _ShardedExtract:
    """The function :func:`make_sharded_extract_fn` returns: this rank's
    uint8 band [H/n, W] -> the whole frame's ``SiftFeatures`` on every
    rank. ``traffic`` counts the collectives of the calls since it was
    last cleared and the bytes this rank sent in them (``exchange``,
    ``gather``, ``psum``; none at one rank, where each collective is the
    identity). ``band_counts`` holds the last call's candidates and
    drops on this rank, i64[2, n_oct] on its device (a sharded octave's
    of its band, a replicated octave's of the whole octave)."""

    def __init__(self, cfg: SiftConfig, plan, mesh: Mesh, axis_name: str,
                 S: int, hk: int):
        self.cfg, self.plan, self.mesh, self.axis = cfg, plan, mesh, axis_name
        self.n = axis_size(mesh, axis_name)
        self.hk = hk
        self.layout = _Layout(plan, self.n, axis_index(mesh, axis_name), S,
                              hk)
        self.traffic = collections.Counter()
        self.band_counts = None

    def _halo(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        return _exchange_halo(x, halo, self.mesh, self.axis, self.traffic)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.n > 1:
            _count(self.traffic, "gather", x)
        return all_gather(x.contiguous(), self.mesh, tiled=True,
                          axis_name=self.axis)

    def _pyramid(self, img: torch.Tensor) -> tuple:
        """Per octave the keypoint-stage blur stack (halo hk on a sharded
        octave) and the detection DoG stack (halo HD)."""
        cfg, P, lay = self.cfg, self.plan.pyramid, self.layout
        total = cfg.total_levels
        relative_all = cfg.gauss_mode == "vlfeat-relative-all"
        blur_k, dog_d = [], []
        src = None
        for o in range(lay.S):
            ow = P.dims[o][1]
            if o == 0:
                lvl0 = _octave0_level0(img, P, pad_rows=self._halo)
            else:
                lvl0 = pick_every_second(src, lay.band[o], ow)
            levels, dogs = [lvl0], []
            for lvl in range(1, total):
                k = P.absN_kernels[lvl] if relative_all else P.inc_kernels[lvl]
                blur, dog = _sharded_blur(lvl0 if relative_all else levels[-1],
                                          k, self.mesh, self.axis,
                                          self.traffic)
                levels.append(blur)
                dogs.append(dog)
            blur = torch.stack(levels)
            dog = blur[1:] - blur[:-1] if relative_all else torch.stack(dogs)
            src = blur[total - 3]
            blur_k.append(self._halo(blur, self.hk))
            dog_d.append(self._halo(dog, HD))
        if lay.S < len(P.dims):
            # the replicated tail from the gathered picks of the last band
            oh, ow = P.dims[lay.S]
            seed = self._gather(pick_every_second(src, lay.band[-1] // 2,
                                                  ow))[:oh]
            blurs, dogs = build_pyramid_from(seed[None], P, lay.S)
            blur_k += [b[0] for b in blurs]
            dog_d += [d[0] for d in dogs]
        return blur_k, dog_d

    def __call__(self, band) -> SiftFeatures:
        cfg, lay = self.cfg, self.layout
        dev = self.mesh.device
        img = _frames_tensor(band, dev)
        want = (self.plan.height // self.n, self.plan.width)
        if tuple(img.shape) != want:
            raise ValueError(f"band {tuple(img.shape)}, expected {want}")
        c = lay.const(dev)
        S = lay.S
        blur_k, dog_d = self._pyramid(img)

        # detection over all octaves: each band's own rows, global rows
        masks = _ext.band_masks(_ext.candidate_masks(dog_d, cfg), lay.windows)
        rows = _ext.compact_octaves(masks, cfg, lay.caps)
        state = _ext.refine_octaves(dog_d, rows, cfg, lay.caps,
                                    y_offsets=lay.det_offset,
                                    heights=lay.heights)
        valid_rows = c["local_row"] < rows.n_found.view(-1)[c["segment"]]
        g = _ext.finalize_refined(state, valid_rows, cfg, c["w_row"],
                                  c["h_row"], rows.n_found.sum(),
                                  rows.n_dropped.sum(),
                                  y_offset=c["det_offset"])

        # the whole frame's extrema on every rank
        ks = lay.k_sharded
        mine = _pack([g.x, g.y, g.sigma], [g.cell, g.valid])
        whole = torch.cat([self._gather(mine[:ks]), mine[ks:]])[c["kp_from"]]
        x, y, sigma, cell, valid = _unpack(whole, (1, 1, 1, 1, 1))
        x, y, sigma = (_as_f32(t)[:, 0] for t in (x, y, sigma))
        valid = valid[:, 0].bool()
        counts = self.band_counts = torch.stack([rows.n_found[0],
                                                 rows.n_dropped[0]])
        if self.n > 1:
            _count(self.traffic, "psum", counts[:, :S])
        counts = torch.cat([psum(counts[:, :S], self.mesh, self.axis),
                            counts[:, S:]], 1)
        if cfg.filter_max_extrema > 0:
            valid = maybe_grid_filter(cell[:, 0].long()[None],
                                      (sigma * c["eff_scale"])[None],
                                      valid[None], cfg)[0]

        # orientation and descriptors of this rank's keypoints
        ends_k = np.cumsum(lay.caps)
        ext = g._replace(valid=valid[c["own"]])
        hist = _ori.orientation_histograms_octaves(
            blur_k, ext, cfg, ends_k, y_offsets=lay.kp_offset,
            y_bounds=lay.kp_bounds)
        oris = _ori.orientations_from_histograms(hist, ext.valid,
                                                 smoothing=cfg.ori_smoothing)
        segs = tuple((int(e - cap), cap, jcap)
                     for e, cap, jcap in zip(ends_k, lay.caps, lay.jcaps))
        jobs, _ = _desc.make_descriptor_jobs_segmented(
            g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid, segs)
        if cfg.desc_mode != "loop":
            # the plain-torch variants read each stack in its own rows
            jobs = jobs._replace(y=jobs.y - c["job_y_offset"])
        raw = _desc.compute_descriptors_octaves(
            blur_k, jobs, np.cumsum(lay.jcaps), cfg,
            y_offsets=lay.kp_offset, y_bounds=lay.kp_bounds)
        desc = _desc.normalize_descriptors(raw, cfg)
        desc = torch.where(jobs.valid[:, None], desc, torch.zeros_like(desc))

        # gather the per-band results in the assembled layout
        mine = _pack([oris.ori], [oris.ori_valid, oris.num_ori])
        whole = torch.cat([self._gather(mine[:ks]), mine[ks:]])[c["kp_from"]]
        ori, ori_valid, num_ori = _unpack(whole, (4, 4, 1))
        js = lay.j_sharded
        mine = _pack([desc], [jobs.kp_index + c["job_kp_offset"],
                              jobs.valid])
        whole = torch.cat([self._gather(mine[:js]),
                           mine[js:]])[c["job_from"]]
        desc, desc_kp, desc_valid = _unpack(whole, (128, 1, 1))
        desc_valid = desc_valid[:, 0].bool()
        scale = c["eff_scale"]
        return SiftFeatures(
            x=x * scale, y=y * scale, sigma=sigma * scale,
            octave=c["eff_octave"].clone(), num_ori=num_ori[:, 0].long(),
            valid=valid, ori=_as_f32(ori), ori_valid=ori_valid.bool(),
            desc=_as_f32(desc), desc_kp=desc_kp[:, 0].long(),
            desc_valid=desc_valid, n_keypoints=valid.sum(),
            n_descriptors=desc_valid.sum(), octave_candidates=counts[0],
            octave_dropped=counts[1])


def make_sharded_extract_fn(cfg: SiftConfig, height: int, width: int,
                            mesh: Mesh, axis_name: str = "sp",
                            octave_caps: tuple | None = None,
                            desc_chunk: int = 1024):
    """(fn, eff_ext_caps): fn maps this rank's uint8 band [H/n, W] of a
    frame (rows split over the ``axis_name`` axis of ``mesh``, n ranks)
    to the whole frame's ``SiftFeatures``, the same on every rank, laid
    out as JAX's sharded extraction lays them out: per sharded octave its
    capacity is ceil(cap / n) a rank, so the assembled frame has the
    per-octave capacities ``eff_ext_caps``; single-device ``extract``
    with ``octave_caps=eff_ext_caps`` gives the same features.

    Each rank runs the port's kernels on its band (the module docstring
    says how). ``desc_chunk`` is JAX's chunking of its XLA descriptor
    loop; the port's descriptor stages size their own work, so it is
    accepted and unused. Raises ValueError, before any collective, for
    direct scaling, the fixed Gauss modes, an upscale other than the
    default 2x (shift 1) or none, a height that does not divide by n, or
    a band thinner than the keypoint halo."""
    plan = build_extract_plan(cfg, height, width, octave_caps=octave_caps)
    n = axis_size(mesh, axis_name)
    if cfg.scaling_mode != "indirect" or cfg.gauss_mode in ("fixed9",
                                                            "fixed15"):
        raise ValueError("sharded extract supports indirect scaling with "
                         "incremental/relative gauss modes")
    if height % n:
        raise ValueError(f"input height {height} not divisible by mesh {n}")
    oh0, ow0 = plan.pyramid.dims[0]
    if not (polyphase0(plan.pyramid) or (oh0, ow0) == (height, width)):
        raise ValueError("sharded extract supports upscale factor 1 "
                         "(default 2x) or 0")
    # keypoint-stage halo: the widest window any stage reads round a
    # keypoint
    hk = max(_ori.max_ori_radius(cfg) + 2, _desc.loop_patch_radius(cfg) + 1)
    S = shardable_octaves(plan, n, min_band=max(hk, 2 * HD))
    if S == 0:
        raise ValueError(
            f"band {oh0 // n} rows is smaller than the keypoint halo {hk}; "
            f"use fewer devices")
    fn = _ShardedExtract(cfg, plan, mesh, axis_name, S, hk)
    return fn, fn.layout.eff_caps


def make_batched_sharded_extract_fn(cfg: SiftConfig, height: int,
                                    width: int, mesh: Mesh,
                                    dp_axis: str = "dp", sp_axis: str = "sp",
                                    octave_caps: tuple | None = None,
                                    desc_chunk: int = 1024):
    """DP x SP: (fn, eff_ext_caps) for a batch of large frames on a 2-D
    mesh (``make_mesh_2d(dp, sp, names=(dp_axis, sp_axis))``). fn maps
    this rank's bands uint8 [B/dp, H/sp, W] (its ``dp_axis`` group's
    frames, their rows split over the ``sp_axis`` ranks of the group) to
    their ``SiftFeatures`` with a leading [B/dp] axis, the same on every
    rank of the group: the frames run one after another, each row-sharded
    over ``sp_axis``, whose subgroup carries every halo exchange and
    gather. ``parallel/batch.py::gather_features`` over ``dp_axis``
    assembles the whole batch."""
    axis_size(mesh, dp_axis)          # raises if the mesh has no such axis
    one, eff_caps = make_sharded_extract_fn(
        cfg, height, width, mesh, axis_name=sp_axis,
        octave_caps=octave_caps, desc_chunk=desc_chunk)

    def fn(bands) -> SiftFeatures:
        feats = [one(b) for b in _frames_tensor(bands, mesh.device)]
        return SiftFeatures(*(torch.stack(f) for f in zip(*feats)))

    fn.traffic = one.traffic
    return fn, eff_caps
