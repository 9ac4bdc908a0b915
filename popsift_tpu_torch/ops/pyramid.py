"""Gaussian scale-space pyramid in PyTorch (default path).

Port of :mod:`popsift_tpu.ops.pyramid`. Each octave is a dense
``f32[L, H, W]`` stack of blur levels and an ``f32[L-1, H, W]`` stack of
DoG layers, stored in 0..255 scale:

* octave 0 level 0 comes straight from the input through the polyphase
  form of (2x upsample -> dd[0] horizontal -> inc[0] vertical);
* levels 1..L-1 by incremental separable blur with edge-replicated
  borders, each with its DoG, DoG[l-1] = blur[l] - blur[l-1], in one
  call of kernel K5 (ops/kernels/blur_dog.py) per level for all frames,
  and for the thin octaves (a plane of at most 4096 pixels, 34 x 60 and
  smaller at 1080p) in ONE call for all their levels (``front="level"``, the default), or in one call of kernel K7
  (ops/kernels/blur_chain.py) per group of three levels
  (``front="chain"``, the JAX package's ``use_pallas="chain"``); both
  give the same planes bit for bit;
* octave o>0 level 0 picks every second pixel of level L-3 of the
  previous octave: K5's launch for that level writes it as a second
  output (the chain front and the plain versions copy the slice).

The blurs are the JAX package's shift-and-add stencils with the same
terms in the same order: in K5, or in its plain version (plain f32
tensor ops) on the CPU and with ``plain=True``. Deliberately not
``F.conv2d``: cuDNN runs f32 convolutions in TF32 by default, three
decimal digits that the DoG threshold cannot afford (the JAX code
avoided MXU convolutions for the same reason). Level 0 (the polyphase
upscale, the decimation) is plain torch, as it was XLA in JAX.

:func:`build_pyramid_frames` builds F same-sized frames at once, each
octave as f32[F, L, H, W] and f32[F, L-1, H, W]; :func:`build_pyramid`
is its one-frame form.

The non-default strategies (direct scaling, fixed9/fixed15,
vlfeat-relative-all, interpolated downscale) raise NotImplementedError;
they are ROADMAP item A9.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import SiftConfig
from ..gauss import GaussTables, build_gauss_tables, full_kernel
from ..utils.f32 import div
from .kernels.blur_chain import blur_chain, blur_chain_torch
from .kernels.blur_dog import (THIN_MAX_OCTAVES, _pad_edge, blur_dog,
                               blur_dog_thin, blur_dog_thin_torch,
                               blur_dog_torch, pick_every_second, thin_fits)

FRONTS = ("level", "chain")
CHAIN_GROUP = 3    # levels fused per K7 launch, as the JAX front's group=3


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


def _octave0_level0(img: torch.Tensor, plan: PyramidPlan) -> torch.Tensor:
    """Octave-0 level 0 from the input for the default 2x upscale: four
    quarter-resolution phase planes convolved on the source image and
    interleaved into [2H, 2W]."""
    oh, ow = plan.dims[0]
    if not (oh == 2 * plan.in_h and ow == 2 * plan.in_w
            and plan.shift0 == 1.0):
        raise NotImplementedError(
            "octave-0 resampling other than the default 2x upscale "
            "(ROADMAP A9)")
    src = _input_as_float(img)
    kxp = _phase_kernels(plan.lvl0_kernel_x * 255.0)
    kyp = _phase_kernels(plan.lvl0_kernel_y)
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


def first_thin_octave(plan: PyramidPlan, front: str = "level") -> int:
    """Index of the first octave whose levels go through K5's one-launch
    thin entry (every later octave does too); ``len(plan.dims)`` if none
    does: only the level front has the entry, and it picks the next
    octave from a level it writes."""
    n_oct = len(plan.dims)
    first = n_oct
    if front == "level" and plan.config.total_levels - 3 >= 1:
        while first > 0 and n_oct - first < THIN_MAX_OCTAVES and thin_fits(
                *plan.dims[first - 1], plan.inc_kernels[1:]):
            first -= 1
    return first


def build_pyramid_frames(imgs: torch.Tensor, plan: PyramidPlan,
                         plain: bool = False, front: str = "level"):
    """Pyramids of F same-sized frames, ``imgs`` [F, H, W] uint8 (or
    [0, 1] float32). Returns (blurs, dogs): tuples over octaves of
    f32[F, L, H, W] and f32[F, L-1, H, W] on the images' device. With
    ``front="level"`` each level runs K5 once for all F frames and the
    thin octaves run all their levels in one K5 launch, with
    ``front="chain"`` each group of three levels runs K7 once (their
    plain versions with ``plain``)."""
    cfg = plan.config
    if front not in FRONTS:
        raise ValueError(f"front must be one of {FRONTS}, got {front!r}")
    if cfg.scaling_mode == "direct":
        raise NotImplementedError("direct scaling (ROADMAP A9)")
    if cfg.gauss_mode in ("fixed9", "fixed15", "vlfeat-relative-all"):
        raise NotImplementedError(
            f"gauss mode {cfg.gauss_mode!r} (ROADMAP A9)")
    if cfg.downscale_mode != "pick":
        raise NotImplementedError(
            f"downscale mode {cfg.downscale_mode!r} (ROADMAP A9)")
    blur_level = blur_dog_torch if plain else blur_dog
    chain = blur_chain_torch if plain else blur_chain
    F = imgs.shape[0]
    total = cfg.total_levels
    dev = imgs.device
    blurs = [torch.empty((F, total, oh, ow), dtype=torch.float32, device=dev)
             for oh, ow in plan.dims]
    dogs = [torch.empty((F, total - 1, oh, ow), dtype=torch.float32,
                        device=dev) for oh, ow in plan.dims]
    src_lvl = total - 3     # the level the next octave is picked from
    n_oct = len(blurs)
    first_thin = first_thin_octave(plan, front)
    for octv, (levels, dog) in enumerate(zip(blurs, dogs)):
        if octv == 0:
            for f in range(F):
                levels[f, 0] = _octave0_level0(imgs[f], plan)
        if octv >= first_thin:
            break
        nxt = blurs[octv + 1][:, 0] if octv + 1 < n_oct else None
        if front == "chain":
            for l0 in range(1, total, CHAIN_GROUP):
                l1 = min(total, l0 + CHAIN_GROUP)
                chain(levels[:, l0 - 1], plan.inc_kernels[l0:l1],
                      out=(levels[:, l0:l1], dog[:, l0 - 1:l1 - 1]))
        else:
            for lvl in range(1, total):
                blur_level(levels[:, lvl - 1], plan.inc_kernels[lvl],
                           out=(levels[:, lvl], dog[:, lvl - 1]),
                           pick=nxt if lvl == src_lvl else None)
        if nxt is not None and (front == "chain" or src_lvl < 1):
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
