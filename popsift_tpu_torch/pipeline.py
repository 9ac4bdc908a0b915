"""End-to-end SIFT extraction in PyTorch.

Port of :mod:`popsift_tpu.pipeline` -- the dense-stack (non-canvas)
branch of ``extract`` (pipeline.py:237-406) and of ``extract_batch``
(pipeline.py:409-753): the pyramid as dense per-octave stacks, F frames'
stacks back to back on the layer axis ([F*L, H, W] and [F*(L-1), H, W]),
then for all octaves and frames at once: the candidate masks (K1), the
compaction (the compaction kernel), the refinement (K2), ONE accept test,
the grid filter of each frame (when ``filter_max_extrema > 0``), the
orientation histograms (K3), one orientation tail, one segmented job
build, the descriptors (K4 for ``desc_mode="loop"``, plain torch for the
other variants), normalisation and the output tail (octave scaling,
descriptor -> keypoint map). Every ``SiftConfig`` the JAX package accepts
runs, on both routes and both fronts. K3 and K4 address frame f's level
l as layer f*L + l.

No count comes back to the host: the compaction writes the candidate
counts on the device and every later stage reads them there, and the
per-plan constants (row dims, octave ids, scales, offsets) are made once
per (plan, frames, device) and kept on the plan. On a CUDA device an
extraction of an uploaded frame queues its work and returns without
waiting for the card. :func:`extract` is the one-frame form of
:func:`extract_batch`: both run the same stages, and every output of the
batch gains a leading [F] axis.

Because nothing is read back and every shape is static per plan, a CUDA
extraction after the upload is the same chain of kernels on the same
buffers every time. :func:`extract_batch` runs it eagerly on the first
call for a key (plan, frames, device, input dtype, route, front), which
makes the plan's constants and the kernel library; the second call
captures it as a CUDA graph, kept on the plan; that call and every later
one copy their frames into the graph's input, replay the graph (one
launch instead of about 360) and copy the outputs into tensors of the
call's own, so that each result outlives the next replay. The CPU and
``plain`` stay eager.

With ``pack=True`` the extraction also packs, in the same graph, the
rows that ``api.FeaturesHost`` keeps to the front of buffers of the
plan's capacity, with a header of counts (:func:`pack_kept`), so that a
job's ``get`` copies only those rows to the host.

:func:`calibrate_plan` sizes per-octave capacities from a detect-only
probe (pipeline.py:787-831). :func:`make_extract_fn` is JAX's closure
over :func:`extract`, and ``detect_extrema``, ``assign_orientations``
and ``make_descriptor_jobs`` are re-exported, as JAX's pipeline.py:31-38
does, for callers that walk one octave at a time.

Two keywords choose between the JAX package's routes. ``detect="fused"``
(the default; JAX's ``POPSIFT_TPU_FUSED_REFINE=1``) refines with K2
straight from the DoG stacks. ``detect="windows"`` is the JAX package's
default route (pipeline.py:233-276): per octave K6 also copies each
candidate's DoG window, then ONE ``refine_patches`` runs over the merged
windows of all octaves. ``front="level"`` (the default) blurs with K5
once per level, ``front="chain"`` with K7 once per group of levels
(JAX's ``use_pallas="chain"``). Both routes give the same features.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .config import SiftConfig
from .ops import descriptors as _desc
from .ops import extrema as _ext
from .ops import orientation as _ori
from .ops.descriptors import make_descriptor_jobs  # noqa: F401 (public surface)
from .ops.extrema import detect_extrema  # noqa: F401 (public surface)
from .ops.orientation import assign_orientations  # noqa: F401 (public surface)
from .ops.gridfilter import maybe_grid_filter
from .ops.pyramid import (PyramidPlan, build_pyramid, build_pyramid_frames,
                          build_pyramid_plan)
from .utils.device import resolve_device
from .utils.profiling import count, span, to_host


class SiftFeatures(NamedTuple):
    """Capacity-padded extraction result (tensors on the run's device)."""

    x: torch.Tensor            # keypoints [K_total], input-image coords
    y: torch.Tensor
    sigma: torch.Tensor
    octave: torch.Tensor
    num_ori: torch.Tensor
    valid: torch.Tensor
    ori: torch.Tensor          # [K_total, 4]
    ori_valid: torch.Tensor    # [K_total, 4]
    desc: torch.Tensor         # [F_total, 128]
    desc_kp: torch.Tensor      # [F_total] -> keypoint row (reverse map)
    desc_valid: torch.Tensor   # [F_total]
    n_keypoints: torch.Tensor
    n_descriptors: torch.Tensor
    octave_candidates: torch.Tensor   # i64[n_octaves], saturates at cap
    octave_dropped: torch.Tensor      # i64[n_octaves], density clamp


class Packed(NamedTuple):
    """The rows of a result that ``api.FeaturesHost`` keeps, packed on the
    run's device; both fields gain a leading [F] axis in a batch.
    ``data`` holds each field of :data:`PACKED_FIELDS`, its kept rows in
    row order, back to back from byte 0 (:func:`packed_offsets`), so that
    all the kept rows are one prefix; the bytes behind it are to be
    ignored."""

    header: torch.Tensor   # i64[2 + 2 * n_octaves]: kept keypoints,
    #                        descriptors, octave_candidates, _dropped
    data: torch.Tensor     # u8[bytes at full capacity]


# FeaturesHost's fields in the order Packed.data holds them: (name, dtype,
# row shape). Larger rows come first and every row's size is a power of
# two, so that each field starts at a multiple of its row's bytes.
PACKED_FIELDS = (
    ("descriptors", torch.float32, (128,)),
    ("orientations", torch.float32, (4,)),
    ("octave", torch.int64, ()),
    ("num_ori", torch.int64, ()),
    ("desc_to_kp", torch.int64, ()),
    ("x", torch.float32, ()),
    ("y", torch.float32, ()),
    ("sigma", torch.float32, ()),
    ("ori_valid", torch.bool, (4,)),
)
_DESC_FIELDS = ("descriptors", "desc_to_kp")
# each field's bytes a row, and whether it has a row a descriptor
_ROWS = tuple((d.itemsize * math.prod(s), n in _DESC_FIELDS)
              for n, d, s in PACKED_FIELDS)


def packed_offsets(n_kp, n_desc) -> tuple:
    """The byte offset of each field of :data:`PACKED_FIELDS` in
    ``Packed.data`` for ``n_kp`` kept keypoints and ``n_desc``
    descriptors (ints, or tensors of one per frame), and the end of the
    last field."""
    at, offsets = n_kp * 0, []              # an int, or a tensor as n_kp
    for row, per_desc in _ROWS:
        offsets.append(at)
        at = at + row * (n_desc if per_desc else n_kp)
    return offsets, at


@dataclass(frozen=True)
class ExtractPlan:
    """Static plan: shapes, capacities and filters for one (config, size)."""

    config: SiftConfig
    height: int
    width: int
    pyramid: PyramidPlan
    ext_caps: tuple      # per-octave extrema capacity
    job_caps: tuple      # per-octave descriptor-job capacity
    # per (frames, device): the plan's constant tensors (_constants)
    _constants: dict = field(default_factory=dict, init=False,
                             compare=False, repr=False)
    # per graph key: _SEEN after the first call, then the _Graph
    _graphs: dict = field(default_factory=dict, init=False,
                          compare=False, repr=False)
    _graph_lock: threading.Lock = field(default_factory=threading.Lock,
                                        init=False, compare=False,
                                        repr=False)


def build_extract_plan(config: SiftConfig, height: int, width: int,
                       octave_caps: tuple | None = None) -> ExtractPlan:
    """The static plan; ``octave_caps`` optionally pins per-octave
    extrema capacities (the last entry repeats). Job capacity is 1.25x
    (sift_constants.cu:31)."""
    pyr = build_pyramid_plan(config, height, width)
    ext_caps, job_caps = [], []
    for octv, (oh, ow) in enumerate(pyr.dims):
        if octave_caps is not None:
            cap = octave_caps[min(octv, len(octave_caps) - 1)]
        else:
            cap = config.capacity_for_octave(oh, ow)
        cap = min(cap, config.max_extrema)
        ext_caps.append(cap)
        job_caps.append(cap + cap // 4)
    return ExtractPlan(config=config, height=height, width=width,
                       pyramid=pyr, ext_caps=tuple(ext_caps),
                       job_caps=tuple(job_caps))


DETECT_ROUTES = ("fused", "windows")


def _check_route(detect: str) -> None:
    if detect not in DETECT_ROUTES:
        raise ValueError(f"detect must be one of {DETECT_ROUTES}, "
                         f"got {detect!r}")


class _Constants(NamedTuple):
    """Tensors of a plan for F frames that depend on nothing else."""

    w_row: torch.Tensor       # i64[F*Ktot] width of each row's octave
    h_row: torch.Tensor       # i64[F*Ktot]
    local_row: torch.Tensor   # i64[F*Ktot] row within its octave
    segment: torch.Tensor     # i64[F*Ktot] f * n_oct + o
    octave: torch.Tensor      # i64[F*Ktot]
    scale: torch.Tensor       # f32[F*Ktot] 2^(o - upscale)
    job_order: torch.Tensor | None   # job rows octave-major -> frame-major
    job_kp_offset: torch.Tensor      # i64[F*Jtot] first row of the octave
    segments: tuple          # (first row, K, jcap) a segment, octave-major
    level_offsets: tuple | None      # f * L a segment (F > 1)
    jobs_layout: dict        # the segmented job build's index tensors


def _constants(plan: ExtractPlan, F: int, dev: torch.device) -> _Constants:
    """The plan's constant tensors for F frames on ``dev``, made once and
    kept on the plan (a host-to-device copy waits for the stream)."""
    key = (F, dev)
    if key in plan._constants:
        return plan._constants[key]
    caps, jcaps = np.asarray(plan.ext_caps), np.asarray(plan.job_caps)
    n_oct = len(caps)
    dims = np.asarray(plan.pyramid.dims, np.int64)
    octave = np.repeat(np.arange(n_oct), caps)
    local = np.arange(caps.sum()) - np.repeat(np.cumsum(caps) - caps, caps)
    scale = np.exp2(octave.astype(np.float32)
                    - np.float32(plan.config.upscale_factor)).astype(
                        np.float32)
    # K4 runs on job rows octave-major (octave o's F segments back to
    # back); the outputs are frame-major
    job_first = np.cumsum(jcaps) - jcaps
    order = np.concatenate([
        F * job_first[o] + f * jcaps[o] + np.arange(jcaps[o])
        for f in range(F) for o in range(n_oct)])
    t = lambda a: torch.as_tensor(np.tile(a, F), device=dev)
    # one segment a (octave, frame), octave-major: K4's job rows
    Ktot, L = int(caps.sum()), plan.config.total_levels
    first = np.cumsum(caps) - caps
    segs = tuple((f * Ktot + int(first[o]), int(caps[o]), int(jcaps[o]))
                 for o in range(n_oct) for f in range(F))
    lev = tuple(f * L for o in range(n_oct) for f in range(F)) \
        if F > 1 else None
    c = _Constants(
        w_row=t(dims[octave, 1]), h_row=t(dims[octave, 0]),
        local_row=t(local),
        segment=torch.as_tensor(np.repeat(np.arange(F), caps.sum()) * n_oct
                                + np.tile(octave, F), device=dev),
        octave=t(octave), scale=t(scale),
        job_order=None if F == 1 else torch.as_tensor(order, device=dev),
        job_kp_offset=t(np.repeat(np.cumsum(caps) - caps, jcaps)),
        segments=segs, level_offsets=lev,
        # kept with the plan: a captured graph reads them by address
        jobs_layout=_desc._segment_layout(segs, lev, dev))
    plan._constants[key] = c
    return c


def _frames_tensor(imgs, dev: torch.device) -> torch.Tensor:
    """The frames on ``dev``: a tensor is moved (no copy if it lies
    there already), anything else goes through numpy."""
    with span("upload"):
        if isinstance(imgs, torch.Tensor):
            return imgs.to(dev)
        return torch.as_tensor(np.asarray(imgs)).to(dev)


def extract(img, plan: ExtractPlan, device, *, plain: bool = False,
            detect: str = "fused", front: str = "level") -> SiftFeatures:
    """Run the full pipeline on one [H, W] uint8 (or [0, 1] float32)
    image, given as a numpy array or tensor, on ``device``. ``detect``
    and ``front`` choose the detection route and the pyramid front (see
    the module docstring).

    On a CUDA device every kernel stage runs its CUDA kernel, and nothing
    waits for the card after the image is on it. ``plain`` runs every
    stage's plain PyTorch version instead, on the same device: the
    baseline the kernels are timed against. It is never chosen on its
    own."""
    if not isinstance(img, torch.Tensor):
        img = np.asarray(img)
    if tuple(img.shape) != (plan.height, plan.width):
        raise ValueError(f"image {tuple(img.shape)} does not match the plan "
                         f"({plan.height}, {plan.width})")
    return frame_features(extract_batch(img[None], plan, device, plain=plain,
                                        detect=detect, front=front), 0)


def extract_batch(imgs, plan: ExtractPlan, device, *, plain: bool = False,
                  detect: str = "fused", front: str = "level",
                  pack: bool = False):
    """Run the pipeline on F same-sized frames at once, ``imgs`` [F, H, W]
    uint8 (or [0, 1] float32) as a numpy array or tensor, on ``device``.
    Every output gains a leading [F] axis; frame f's row equals
    ``extract`` of that frame. ``plain``, ``detect`` and ``front`` as in
    :func:`extract`. Returns the :class:`SiftFeatures`, or with ``pack``
    the pair of them and their :class:`Packed` rows. On a CUDA device,
    from the second call for a key on, the stages after the upload
    replay as one CUDA graph (see the module docstring); the result is
    bit for bit the eager one, in tensors of its own."""
    _check_route(detect)
    dev = resolve_device(device)
    imgs = _frames_tensor(imgs, dev)
    if imgs.dim() != 3 or tuple(imgs.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"frames {tuple(imgs.shape)} do not match the plan "
                         f"(F, {plan.height}, {plan.width})")
    F = imgs.shape[0]
    count("frames", F)
    count("rows_padded.desc", F * sum(plan.job_caps))
    if dev.type != "cuda" or plain:
        return _extract_frames(imgs, plan, plain, detect, front, pack)
    key = (F, dev, imgs.dtype, detect, front, pack)
    with plan._graph_lock:
        g = plan._graphs.get(key)
        if g is None:
            # eager: makes the plan's constants, the kernel library and
            # the cached tensors that a capture must find made
            plan._graphs[key] = _SEEN
            return _extract_frames(imgs, plan, False, detect, front, pack)
        if g is _SEEN:
            g = plan._graphs[key] = _Graph(
                imgs, lambda x: _extract_frames(x, plan, False, detect,
                                                front, pack))
            count("graph_captures")
        with span("graph"):
            count("frames.graph", F)
            return g.run(imgs)


_SEEN = "seen"       # a graph key's state after its first, eager call


class _Graph:
    """One extraction captured as a CUDA graph: the static input it
    reads, the outputs it writes and the graph. Captured on a side
    stream without ``torch.cuda.graph``, which synchronises the device
    (the extraction promises none), and in the thread's own capture
    mode, so that other threads' work on the card goes on."""

    def __init__(self, like: torch.Tensor, fn):
        dev = like.device
        self.input = torch.empty(like.shape, dtype=like.dtype, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.free = torch.cuda.Event()       # the last run's outputs copied
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.output = fn(self.input)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def run(self, imgs: torch.Tensor):
        """Replay on ``imgs`` [F, H, W] (on the graph's device): copy them
        in, replay, and copy every output into a tensor of the caller's,
        all on the current stream, after the previous run's copies."""
        stream = torch.cuda.current_stream(imgs.device)
        stream.wait_event(self.free)
        self.input.copy_(imgs)
        self.graph.replay()
        if isinstance(self.output, SiftFeatures):
            out = _cloned(self.output)
        else:
            out = tuple(_cloned(o) for o in self.output)
        self.free.record(stream)
        return out


def _cloned(out):
    return type(out)(*(t.clone() for t in out))


def _extract_frames(imgs: torch.Tensor, plan: ExtractPlan, plain: bool,
                    detect: str, front: str, pack: bool = False):
    """The stages after the upload, eagerly: ``imgs`` [F, H, W] on the
    device, checked against the plan. Queues its work and reads nothing
    back, so that a CUDA graph can capture it. With ``pack``, also the
    :class:`Packed` rows (:func:`extract_batch`)."""
    cfg = plan.config
    dev = imgs.device
    F = imgs.shape[0]
    L = cfg.total_levels
    caps = plan.ext_caps
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    Ktot = int(offs[-1])
    const = _constants(plan, F, dev)

    # frames stacked on the layer axis: [F, L, H, W] -> [F*L, H, W]
    with span("front"):
        blurs, dogs = build_pyramid_frames(imgs, plan.pyramid, plain, front)
        blurs = [b.view(F * L, *b.shape[2:]) for b in blurs]
        dogs = [d.view(F * (L - 1), *d.shape[2:]) for d in dogs]

    # detection: one mask launch, one compaction and (fused) one
    # refinement launch for all octaves and frames; or per octave the
    # windows and one refinement over all octaves' windows; then one
    # accept test over everything. Rows are frame-major: frame f's
    # octaves back to back.
    with span("detect"):
        masks = _ext.candidate_masks(dogs, cfg, F, plain)
        rows = _ext.compact_octaves(masks, cfg, caps, F, plain)
        valid_rows = const.local_row < rows.n_found.view(-1)[const.segment]
        if detect == "windows":
            patches = _ext.window_patches(dogs, rows, caps, F, plain)
            state = _ext.refine_patches(patches, rows.x0, rows.y0, rows.z0,
                                        valid_rows, cfg, const.w_row,
                                        const.h_row)
        else:
            state = _ext.refine_octaves(dogs, rows, cfg, caps, F, plain)
        g = _ext.finalize_refined(state, valid_rows, cfg, const.w_row,
                                  const.h_row, rows.n_found.sum(),
                                  rows.n_dropped.sum())
        if cfg.filter_max_extrema > 0:
            # the grid budget of each frame over the rows of all its
            # octaves, sigma in input-image units (pipeline.py:279-288),
            # before the orientation stage (s_orientation.cu:353-367)
            keep = maybe_grid_filter(g.cell.view(F, Ktot),
                                     (g.sigma * const.scale).view(F, Ktot),
                                     g.valid.view(F, Ktot), cfg)
            g = g._replace(valid=keep.view(-1), count=keep.sum())

    # orientation: one K3 launch over the frame-major rows of all frames
    # and octaves; the kernel takes frame f's level l as layer f*L + l of
    # the stacked blur and zeroes the rows that are not valid
    with span("orient"):
        hist = _ori.orientation_histograms_octaves(blurs, g, cfg, offs[1:],
                                                   F, plain)
        oris = _ori.orientations_from_histograms(
            hist, g.valid, smoothing=cfg.ori_smoothing)

    # descriptors: one job build over all (octave, frame) segments, then
    # one K4 launch over every row (octave-major: octave o's F segments
    # end at row F * jobs_off[o + 1]), then the rows put frame-major
    with span("desc"):
        jobs, _ = _desc.make_descriptor_jobs_segmented(
            g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid,
            const.segments, level_offsets=const.level_offsets,
            layout=const.jobs_layout)
        jobs_off = np.concatenate([[0], np.cumsum(plan.job_caps)])
        jobs_off = jobs_off.astype(int)
        Jtot = int(jobs_off[-1])
        raw = _desc.compute_descriptors_octaves(blurs, jobs,
                                                jobs_off[1:] * F, cfg, plain)
        kp, desc_valid = jobs.kp_index, jobs.valid
        if const.job_order is not None:
            raw, kp, desc_valid = (a[const.job_order]
                                   for a in (raw, kp, desc_valid))
        desc = _desc.normalize_descriptors(raw, cfg)
        desc = torch.where(desc_valid[:, None], desc,
                           torch.zeros_like(desc))

    with span("tail"):
        valid = g.valid.view(F, Ktot)
        desc_valid = desc_valid.view(F, Jtot)
        feats = SiftFeatures(
            x=(g.x * const.scale).view(F, Ktot),
            y=(g.y * const.scale).view(F, Ktot),
            sigma=(g.sigma * const.scale).view(F, Ktot),
            octave=const.octave.view(F, Ktot).clone(),
            num_ori=oris.num_ori.view(F, Ktot),
            valid=valid,
            ori=oris.ori.view(F, Ktot, -1),
            ori_valid=oris.ori_valid.view(F, Ktot, -1),
            desc=desc.view(F, Jtot, 128),
            desc_kp=(kp + const.job_kp_offset).view(F, Jtot),
            desc_valid=desc_valid,
            n_keypoints=valid.sum(1),
            n_descriptors=desc_valid.sum(1),
            octave_candidates=rows.n_found,
            octave_dropped=rows.n_dropped,
        )
        return (feats, pack_kept(feats)) if pack else feats


def _partition(mask: torch.Tensor):
    """Each row's place in the stable partition of each frame's rows
    (``mask`` [F, N]) that puts the rows of ``mask`` first, and their
    number a frame: one prefix sum, nothing read back."""
    m = mask.long()
    upto = m.cumsum(1)
    before = upto - m                  # rows of mask before each row
    n = upto[:, -1]
    i = torch.arange(mask.shape[1], device=mask.device)
    return torch.where(mask, before, n[:, None] + i - before), n


def pack_kept(feats: SiftFeatures) -> Packed:
    """The rows ``api.FeaturesHost`` keeps of a batched result ([F, ...]
    fields), packed on its device at static shapes (:class:`Packed`):
    the keypoints that are valid with at least one orientation, the valid
    descriptors, and each descriptor's keypoint as its place among the
    kept ones. Prefix sums and scatters only, nothing read back, so that
    a CUDA graph can capture it."""
    keep = feats.valid & (feats.num_ori > 0)
    kp_to, n_kp = _partition(keep)
    d_to, n_desc = _partition(feats.desc_valid)
    src = dict(x=feats.x, y=feats.y, sigma=feats.sigma, octave=feats.octave,
               num_ori=feats.num_ori, orientations=feats.ori,
               ori_valid=feats.ori_valid, descriptors=feats.desc,
               desc_to_kp=torch.where(keep, kp_to, -1).gather(
                   1, feats.desc_kp))
    F, K = keep.shape
    offsets, _ = packed_offsets(n_kp, n_desc)
    _, size = packed_offsets(K, feats.desc_valid.shape[1])
    size = -(-size // 512) * 512          # a whole number of every row
    data = torch.empty(F, size, dtype=torch.uint8, device=keep.device)
    # Each field's rows are scattered whole: the kept ones to its place,
    # the others behind them, into the places of the fields after it.
    # Those are scattered later, in this order, so the prefix ends up
    # holding every field's kept rows.
    for (name, dtype, shape), (row, per_desc), at in zip(
            PACKED_FIELDS, _ROWS, offsets):
        to = (d_to if per_desc else kp_to) + (at // row)[:, None]
        rows = data.view(dtype).view(F, size // row, *shape)
        idx = to.view(*to.shape, *(1,) * len(shape)).expand_as(src[name])
        rows.scatter_(1, idx, src[name])
    return Packed(header=torch.cat([n_kp[:, None], n_desc[:, None],
                                    feats.octave_candidates,
                                    feats.octave_dropped], 1),
                  data=data)


_NUMPY = {torch.float32: np.float32, torch.int64: np.int64,
          torch.bool: np.bool_}


def unpack_kept(data: np.ndarray, n_kp: int, n_desc: int) -> dict:
    """FeaturesHost's arrays by name, as views of ``data``: the first
    bytes of a frame's ``Packed.data`` (u8, at least up to
    ``packed_offsets(n_kp, n_desc)[1]``) on the host."""
    offsets, _ = packed_offsets(n_kp, n_desc)
    out = {}
    for (name, dtype, shape), (row, per_desc), at in zip(
            PACKED_FIELDS, _ROWS, offsets):
        n = n_desc if per_desc else n_kp
        out[name] = data[at:at + n * row].view(_NUMPY[dtype]).reshape(
            n, *shape)
    return out


def make_extract_fn(plan: ExtractPlan, device, desc_chunk: int = 1024):
    """The one-frame extraction closure of popsift_tpu.pipeline
    .make_extract_fn (:756-758): ``fn(img)`` is ``extract(img, plan,
    device)``, with no graph capture and no cache of its own.
    ``desc_chunk`` is JAX's chunking of its XLA descriptor loop; the
    port's descriptor stages size their own work, so it is accepted and
    unused."""
    dev = resolve_device(device)
    return lambda img: extract(img, plan, dev)


def frame_features(feats, f: int):
    """Frame ``f`` of a batched result, :class:`SiftFeatures` or
    :class:`Packed` (the leading axis dropped)."""
    return type(feats)(*(a[f] for a in feats))


def saturation_report(feats: SiftFeatures, plan: ExtractPlan) -> list:
    """Warnings when an octave hit its candidate capacity or the
    compaction density clamp dropped candidates (the reference clamps
    silently, s_extrema.cu:551-561)."""
    return saturation_messages(to_host(feats.octave_candidates),
                               to_host(feats.octave_dropped), plan)


def saturation_messages(cand, dropped, plan: ExtractPlan) -> list:
    """:func:`saturation_report`'s warnings from the per-octave candidate
    and dropped counts on the host."""
    warnings = []
    for octv, cap in enumerate(plan.ext_caps):
        if cand[octv] >= cap:
            warnings.append(
                f"octave {octv}: candidate count saturated at capacity "
                f"{cap}; keypoints are being silently dropped -- raise "
                f"extrema_capacity")
        if dropped[octv] > 0:
            warnings.append(
                f"octave {octv}: {int(dropped[octv])} candidates dropped "
                f"by the per-block density clamp; raise "
                f"config.compact_block_k or the peak threshold")
    return warnings


def make_probe_fn(plan: ExtractPlan, device, front: str = "level"):
    """Detect-only probe (pipeline.py:787-804): pyramid and the dense
    candidate collection (one mask launch of K1 over the octaves' dense
    stacks, one compaction), no refinement or later stage, so of the two
    route keywords only ``front`` applies. The returned function maps
    one image to its per-octave candidate counts, i64 numpy
    [n_octaves]."""
    cfg = plan.config
    dev = resolve_device(device)

    def probe(img) -> np.ndarray:
        _, dogs = build_pyramid(_frames_tensor(img, dev), plan.pyramid,
                                front=front)
        masks = _ext.candidate_masks(dogs, cfg)
        rows = _ext.compact_octaves(masks, cfg, plan.ext_caps)
        return to_host(rows.n_found[0])

    return probe


def calibrate_plan(config: SiftConfig, frames, height: int | None = None,
                   width: int | None = None, headroom: float = 1.5,
                   probe_capacity: int = 8192, *, device,
                   front: str = "level") -> ExtractPlan:
    """Plan with per-octave capacities pinned from the candidate counts
    of representative ``frames`` on ``device``, as
    popsift_tpu.pipeline.calibrate_plan (:807-831) sizes them: the
    per-octave maximum times ``headroom``, rounded up to a multiple of
    128, plus 128, at least 256."""
    frames = list(frames)
    if height is None or width is None:
        height, width = np.asarray(frames[0]).shape[-2:]
    probe_cfg = config.replace(extrema_capacity=probe_capacity)
    probe = make_probe_fn(build_extract_plan(probe_cfg, height, width),
                          device, front)
    cand = np.zeros(len(config.octave_dims(width, height)), np.int64)
    for f in frames:
        cand = np.maximum(cand, probe(f))
    caps = tuple(int(max(256, -(-int(c * headroom) // 128) * 128 + 128))
                 for c in cand)
    return build_extract_plan(config, height, width, octave_caps=caps)
