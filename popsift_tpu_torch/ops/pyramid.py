"""Gaussian scale-space pyramid in PyTorch, every strategy of the config.

Port of :mod:`popsift_tpu.ops.pyramid`. Each octave is a dense
``f32[L, H, W]`` stack of blur levels and an ``f32[L-1, H, W]`` stack of
DoG layers, stored in 0..255 scale:

* octave 0 level 0 comes straight from the input: for the default 2x
  upscale with shift 1 through the polyphase form of (2x upsample ->
  dd[0] horizontal -> inc[0] vertical), for any other upscale or shift
  (``sift_mode="opencv"``, ``upscale_factor=0``) by resampling the rows
  and columns at the reference's sample positions and filtering them;
* levels 1..L-1 by incremental separable blur with edge-replicated
  borders, each with its DoG, DoG[l-1] = blur[l] - blur[l-1], in one
  call of kernel K5 (ops/kernels/blur_dog.py) per level for all frames
  (``front="level"``, the default), or in one call of kernel K7
  (ops/kernels/blur_chain.py) per group of three levels
  (``front="chain"``, the JAX package's ``use_pallas="chain"``); on both
  fronts the thin octaves (a plane of at most 4096 pixels, 34 x 60 and
  smaller at 1080p) take ONE call of K5's thin entry for all their
  levels; both fronts give the same planes bit for bit;
* octave o>0 level 0 picks every second pixel of level L-3 of the
  previous octave (``downscale_mode="pick"``): the K5 or K7 launch that
  writes that level writes it as a second output (the plain versions
  copy the slice). ``downscale_mode="interpolate"`` takes the odd pixels
  instead, ``scaling_mode="direct"`` builds it from the input with the
  octave's dd filter.

The other Gauss modes blur from level 0 rather than from the level
before: ``vlfeat-relative-all`` every level of every octave with the
absolute filters, ``fixed9`` / ``fixed15`` every level of octave 0 from
the input with ``abs_o0`` on both axes (plain torch, like the default
octave-0 level) and levels 1..5 of the later octaves from level 0 with
``abs_oN``. Those blurs run K5 with level 0 as the source and one torch
subtraction takes the DoG layers, since K5's DoG is the blur minus its
source. Only an incremental pick-every-second pyramid from the previous
octave (the default strategy) has the thin entry, which picks the next
octave from a level it writes.

The blurs are the JAX package's shift-and-add stencils with the same
terms in the same order: in K5, or in its plain version (plain f32
tensor ops) on the CPU and with ``plain=True``. Deliberately not
``F.conv2d``: cuDNN runs f32 convolutions in TF32 by default, three
decimal digits that the DoG threshold cannot afford (the JAX code
avoided MXU convolutions for the same reason). Level 0 (the resampling,
the decimation) is plain torch, as it was XLA in JAX.

:func:`build_pyramid_frames` builds F same-sized frames at once, each
octave as f32[F, L, H, W] and f32[F, L-1, H, W]; :func:`build_pyramid`
is its one-frame form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ..config import SiftConfig
from ..gauss import GaussTables, build_gauss_tables, full_kernel
from ..utils.f32 import div
from .kernels.blur_chain import blur_chain, blur_chain_torch
from .kernels.blur_dog import (THIN_MAX_OCTAVES, _conv1d_valid, _pad_edge,
                               blur_dog, blur_dog_thin, blur_dog_thin_torch,
                               blur_dog_torch, pick_every_second, thin_fits)

FRONTS = ("level", "chain")
CHAIN_GROUP = 3    # levels fused per K7 launch, as the JAX front's group=3
# Gauss modes whose levels 1..L-1 are blurred from level 0
FROM_LEVEL0 = ("fixed9", "fixed15", "vlfeat-relative-all")


@dataclass(frozen=True)
class PyramidPlan:
    """Static shape/filter data for one (config, input size) pair."""

    config: SiftConfig
    in_h: int
    in_w: int
    dims: tuple            # ((h, w), ...) per octave
    shift0: float          # sub-pixel shift for octave-0 sampling
    inc_kernels: tuple     # full symmetric kernels per level
    absN_kernels: tuple    # level0 -> levelN kernels (relative-all/fixed)
    dd_kernels: tuple      # direct-downscale kernels per octave
    lvl0_kernel_x: np.ndarray  # dd[0] full kernel (horizontal from input)
    lvl0_kernel_y: np.ndarray  # inc[0] full kernel (vertical from interm)
    abs0_kernels: tuple = ()   # input -> octave-0 levelN (fixed modes)
    # per (name, device): resampling constants, made once (_plan_tensor)
    _constants: dict = field(default_factory=dict, init=False,
                             compare=False, repr=False)


def build_pyramid_plan(config: SiftConfig, height: int, width: int,
                       tables: GaussTables | None = None) -> PyramidPlan:
    """Same plan, tap for tap, as popsift_tpu.ops.pyramid.build_pyramid_plan
    (the port's :mod:`..gauss` is a copy of the JAX package's tables)."""
    if tables is None:
        tables = build_gauss_tables(config)
    if (config.sift_mode in ("popsift", "vlfeat")
            or config.gauss_mode in ("fixed9", "fixed15")):
        shift0 = 0.5 * (2.0 ** config.upscale_factor)
    else:
        shift0 = 0.5
    n_oct = config.num_octaves_for(width, height)
    return PyramidPlan(
        config=config,
        in_h=height,
        in_w=width,
        dims=tuple(config.octave_dims(width, height)),
        shift0=shift0,
        inc_kernels=tuple(
            full_kernel(tables.inc[l], int(tables.inc_span[l]))
            for l in range(config.total_levels)),
        absN_kernels=tuple(
            full_kernel(tables.abs_oN[l], int(tables.abs_oN_span[l]))
            for l in range(config.total_levels)),
        dd_kernels=tuple(
            full_kernel(tables.dd[o], int(tables.dd_span[o]))
            for o in range(n_oct)),
        lvl0_kernel_x=full_kernel(tables.dd[0], int(tables.dd_span[0])),
        lvl0_kernel_y=full_kernel(tables.inc[0], int(tables.inc_span[0])),
        abs0_kernels=tuple(
            full_kernel(tables.abs_o0[l], int(tables.abs_o0_span[l]))
            for l in range(config.total_levels)),
    )


def _input_as_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 reads as val/255 (normalized texture); float32 input is
    taken as-is in [0, 1]. The pyramid's *255 applies to both."""
    if img.dtype == torch.uint8:
        return div(img.to(torch.float32), 255.0)
    return img.to(torch.float32)


def _phase_kernels(kernel: np.ndarray):
    """Polyphase decomposition of (2x linear upsample -> conv ``kernel``):
    out[2j + phi] = sum_d img[j + d] * K_phi[d]. Returns
    ((K0, q0min), (K1, q1min)); numpy, identical to the JAX plan."""
    S = (kernel.shape[0] - 1) // 2
    out = []
    for phi in (0, 1):
        taps = {}
        for u in range(kernel.shape[0]):
            t = phi - S + u
            if t % 2 == 0:
                taps[t // 2] = taps.get(t // 2, 0.0) + float(kernel[u])
            else:
                lo = (t - 1) // 2
                taps[lo] = taps.get(lo, 0.0) + 0.5 * float(kernel[u])
                taps[lo + 1] = taps.get(lo + 1, 0.0) + 0.5 * float(kernel[u])
        qmin, qmax = min(taps), max(taps)
        arr = np.zeros(qmax - qmin + 1, np.float64)
        for d, v in taps.items():
            arr[d - qmin] = v
        out.append((arr.astype(np.float32), qmin))
    return tuple(out)


def _conv1d_asym(x: torch.Tensor, taps: np.ndarray, qmin: int, pad: int,
                 dim: int) -> torch.Tensor:
    """Valid conv with an asymmetric kernel on an input already padded
    by ``pad`` on both sides of ``dim``; terms summed in tap order."""
    n = x.shape[dim] - 2 * pad
    out = None
    for i in range(taps.shape[0]):
        term = x.narrow(dim, pad + qmin + i, n) * float(taps[i])
        if out is None:
            out = term
        else:
            out += term
    return out


def _plan_tensor(plan: PyramidPlan, name: str, dev: torch.device,
                 make) -> torch.Tensor:
    """The plan's constant tensor ``name`` on ``dev``, from the numpy
    array ``make()``, copied to the device once and kept on the plan (a
    host-to-device copy waits for the stream)."""
    key = (name, dev)
    if key not in plan._constants:
        plan._constants[key] = torch.as_tensor(make(), device=dev)
    return plan._constants[key]


def _lerp_rows(img: torch.Tensor, pos: np.ndarray, dim: int,
               plan: PyramidPlan, name: str) -> torch.Tensor:
    """Resample ``dim`` of ``img`` at the static numpy positions ``pos``
    with clamp-to-edge, as popsift_tpu.ops.pyramid._lerp_rows: indices
    and weights in numpy, ``a * (1 - f) + b * f`` on the device."""
    n = img.shape[dim]
    p = np.clip(pos, 0.0, n - 1.0)
    i0 = np.floor(p).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    f = (p - i0).astype(np.float32)
    shape = [1] * img.dim()
    shape[dim] = -1
    # the positions are an arithmetic run: its ends, length and the
    # axis's size name it
    key = f"{name}:{n}:{pos.size}:{pos[0]!r}:{pos[-1]!r}"
    t = lambda tag, a: _plan_tensor(plan, f"{key}.{tag}", img.device,
                                    lambda: a)
    w1 = t("f", f).view(shape)
    w0 = t("1-f", np.float32(1.0) - f).view(shape)
    return (img.index_select(dim, t("i0", i0)) * w0
            + img.index_select(dim, t("i1", i1)) * w1)


def _resample_filter(img: torch.Tensor, plan: PyramidPlan, oh: int, ow: int,
                     kx: np.ndarray, ky: np.ndarray, name: str
                     ) -> torch.Tensor:
    """The generic octave-level build from the input
    (popsift_tpu.ops.pyramid._octave0_level0's non-polyphase branch and
    _octave_lvl0_from_input): rows resampled at (y + shift) * (src/dst)
    - 0.5, columns at the same positions over an extended range, a
    valid horizontal pass with ``kx`` (x 255), then edge-replicated rows
    and a valid vertical pass with ``ky``."""
    sh, sw = plan.in_h, plan.in_w
    src = _input_as_float(img)
    pad = (kx.shape[0] - 1) // 2
    ys = (np.arange(oh, dtype=np.float64) + plan.shift0) * (sh / oh) - 0.5
    xs = (np.arange(-pad, ow + pad, dtype=np.float64)
          + plan.shift0) * (sw / ow) - 0.5
    r = _lerp_rows(src, ys, -2, plan, f"{name}.rows")       # [oh, sw]
    r = _lerp_rows(r, xs, -1, plan, f"{name}.cols")         # [oh, ow + 2pad]
    out = _conv1d_valid(r, kx, -1) * 255.0
    pady = (ky.shape[0] - 1) // 2
    return _conv1d_valid(_pad_edge(out, pady, -2), ky, -2)


def _octave0_level0(img: torch.Tensor, plan: PyramidPlan,
                    kx: np.ndarray | None = None,
                    ky: np.ndarray | None = None) -> torch.Tensor:
    """An octave-0 level from the input, ``kx`` horizontally (default
    dd[0]) and ``ky`` vertically (default inc[0]); the fixed modes give
    ``abs_o0[level]`` for both. For the default 2x upscale with shift 1:
    four quarter-resolution phase planes convolved on the source image
    and interleaved into [2H, 2W]; otherwise the resampling of
    :func:`_resample_filter`."""
    oh, ow = plan.dims[0]
    kx = plan.lvl0_kernel_x if kx is None else kx
    ky = plan.lvl0_kernel_y if ky is None else ky
    if not (oh == 2 * plan.in_h and ow == 2 * plan.in_w
            and plan.shift0 == 1.0):
        return _resample_filter(img, plan, oh, ow, kx, ky, "o0")
    src = _input_as_float(img)
    kxp = _phase_kernels(kx * 255.0)
    kyp = _phase_kernels(ky)
    px_pad = max(max(abs(q), abs(q + t.shape[0] - 1)) for t, q in kxp)
    py_pad = max(max(abs(q), abs(q + t.shape[0] - 1)) for t, q in kyp)
    srcp = _pad_edge(_pad_edge(src, py_pad, 0), px_pad, 1)
    rows = []
    for ky_t, ky_q in kyp:
        row = []
        for kx_t, kx_q in kxp:
            p = _conv1d_asym(srcp, kx_t, kx_q, px_pad, 1)
            row.append(_conv1d_asym(p, ky_t, ky_q, py_pad, 0))
        rows.append(torch.stack(row, dim=-1))          # [H, W, px]
    out = torch.stack(rows, dim=1)                     # [H, py, W, px]
    return out.reshape(oh, ow)


def _octave_lvl0_from_input(img: torch.Tensor, plan: PyramidPlan,
                            octv: int) -> torch.Tensor:
    """Direct scaling (``scaling_mode="direct"``): level 0 of octave
    ``octv`` built from the input with the octave's dd filter
    horizontally and inc[0] vertically
    (popsift_tpu.ops.pyramid._octave_lvl0_from_input)."""
    oh, ow = plan.dims[octv]
    return _resample_filter(img, plan, oh, ow, plan.dd_kernels[octv],
                            plan.lvl0_kernel_y, f"o{octv}")


def _decimate2_interpolate(x: torch.Tensor, oh: int, ow: int
                           ) -> torch.Tensor:
    """get_by_2_interpolate of [..., H, W]: the odd rows and columns,
    the last one repeated where an odd-sized source has too few
    (popsift_tpu.ops.pyramid._decimate2_interpolate)."""
    r = x[..., 1::2, :]
    if r.shape[-2] < oh:
        r = torch.cat([r, x[..., -1:, :]], dim=-2)
    c = r[..., 1::2]
    if c.shape[-1] < ow:
        c = torch.cat([c, r[..., -1:]], dim=-1)
    return c


def _thin_allowed(cfg: SiftConfig) -> bool:
    """Whether the octaves blur incrementally and each picks its level 0
    from the previous one: the strategy K5's thin entry computes."""
    return (cfg.scaling_mode == "indirect" and cfg.downscale_mode == "pick"
            and cfg.gauss_mode not in FROM_LEVEL0)


def first_thin_octave(plan: PyramidPlan) -> int:
    """Index of the first octave whose levels go through K5's one-launch
    thin entry (every later octave does too), on either front;
    ``len(plan.dims)`` if none does: only the incremental
    pick-every-second strategy has the entry, which picks the next octave
    from a level it writes."""
    n_oct = len(plan.dims)
    first = n_oct
    if (plan.config.total_levels - 3 >= 1
            and _thin_allowed(plan.config)):
        while first > 0 and n_oct - first < THIN_MAX_OCTAVES and thin_fits(
                *plan.dims[first - 1], plan.inc_kernels[1:]):
            first -= 1
    return first


def build_pyramid_frames(imgs: torch.Tensor, plan: PyramidPlan,
                         plain: bool = False, front: str = "level"):
    """Pyramids of F same-sized frames, ``imgs`` [F, H, W] uint8 (or
    [0, 1] float32). Returns (blurs, dogs): tuples over octaves of
    f32[F, L, H, W] and f32[F, L-1, H, W] on the images' device. With
    ``front="level"`` each level runs K5 once for all F frames, with
    ``front="chain"`` each group of three levels of an incremental mode
    runs K7 once; on both the thin octaves run all their levels in one K5
    launch (their plain versions with ``plain``); the modes that blur
    from level 0 run K5 per level on both fronts, as the JAX package runs
    no chain for them."""
    cfg = plan.config
    if front not in FRONTS:
        raise ValueError(f"front must be one of {FRONTS}, got {front!r}")
    blur_level = blur_dog_torch if plain else blur_dog
    chain = blur_chain_torch if plain else partial(blur_chain,
                                                   group=CHAIN_GROUP)
    F = imgs.shape[0]
    total = cfg.total_levels
    dev = imgs.device
    blurs = [torch.empty((F, total, oh, ow), dtype=torch.float32, device=dev)
             for oh, ow in plan.dims]
    dogs = [torch.empty((F, total - 1, oh, ow), dtype=torch.float32,
                        device=dev) for oh, ow in plan.dims]
    src_lvl = total - 3     # the level the next octave is made from
    n_oct = len(blurs)
    fixed = cfg.gauss_mode in ("fixed9", "fixed15")
    from_level0 = cfg.gauss_mode in FROM_LEVEL0
    picks = cfg.scaling_mode == "indirect" and cfg.downscale_mode == "pick"
    first_thin = first_thin_octave(plan)
    for octv, (levels, dog) in enumerate(zip(blurs, dogs)):
        oh, ow = plan.dims[octv]
        if octv == 0 and fixed:
            # every octave-0 level from the input, abs_o0 on both axes
            for f in range(F):
                for lvl in range(total):
                    k = plan.abs0_kernels[lvl]
                    levels[f, lvl] = _octave0_level0(imgs[f], plan, k, k)
        elif octv == 0:
            for f in range(F):
                levels[f, 0] = _octave0_level0(imgs[f], plan)
        elif cfg.scaling_mode == "direct":
            for f in range(F):
                levels[f, 0] = _octave_lvl0_from_input(imgs[f], plan, octv)
        elif not picks:
            levels[:, 0] = _decimate2_interpolate(
                blurs[octv - 1][:, src_lvl], oh, ow)
        if octv >= first_thin:
            break
        nxt = blurs[octv + 1][:, 0] if picks and octv + 1 < n_oct else None
        picked = False       # whether a K5 or K7 launch wrote nxt
        if octv == 0 and fixed:
            torch.sub(levels[:, 1:], levels[:, :-1], out=dog)
        elif from_level0:
            for lvl in range(1, total):
                blur_level(levels[:, 0], plan.absN_kernels[lvl],
                           out=(levels[:, lvl], dog[:, lvl - 1]),
                           pick=nxt if lvl == src_lvl else None)
            torch.sub(levels[:, 1:], levels[:, :-1], out=dog)
            picked = src_lvl >= 1
        elif front == "chain":
            chain(levels[:, 0], plan.inc_kernels[1:],
                  out=(levels[:, 1:], dog),
                  pick=nxt if src_lvl >= 1 else None, pick_level=src_lvl - 1)
            picked = src_lvl >= 1
        else:
            for lvl in range(1, total):
                blur_level(levels[:, lvl - 1], plan.inc_kernels[lvl],
                           out=(levels[:, lvl], dog[:, lvl - 1]),
                           pick=nxt if lvl == src_lvl else None)
            picked = src_lvl >= 1
        if nxt is not None and not picked:
            # pick every second pixel (get_by_2_pick_every_second)
            nxt.copy_(pick_every_second(levels[:, src_lvl],
                                        *nxt.shape[-2:]))
    if first_thin < n_oct:
        thin = blur_dog_thin_torch if plain else blur_dog_thin
        thin(blurs[first_thin:], dogs[first_thin:],
             list(plan.inc_kernels[1:]), src_lvl)
    return tuple(blurs), tuple(dogs)


def build_pyramid(img: torch.Tensor, plan: PyramidPlan,
                  plain: bool = False, front: str = "level"):
    """Full pyramid of a [H, W] uint8 (or [0, 1] float32) image tensor.
    Returns (blurs, dogs): tuples over octaves of f32[L, H, W] and
    f32[L-1, H, W] on the image's device."""
    blurs, dogs = build_pyramid_frames(img[None], plan, plain, front)
    return tuple(b[0] for b in blurs), tuple(d[0] for d in dogs)
