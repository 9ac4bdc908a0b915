"""Public job API: PopSift / SiftJob / FeaturesHost / FeaturesDev.

Port of :mod:`popsift_tpu.api` (the reference's popsift.h:40-167 and
features.h:65-118) on a PyTorch device chosen explicitly. ``enqueue``
uploads the image, queues the extraction on the current stream and
returns a :class:`SiftJob` without waiting for the card (no count is
read back on the way); ``get`` is where the host waits, bringing the
result to the host. On a CUDA device, from the second call for a frame
size on, the extraction is one replay of a CUDA graph kept with the
size's plan (:mod:`popsift_tpu_torch.pipeline`), and each job owns a
copy of its result. In extracting mode the extraction also packs the
rows ``FeaturesHost`` keeps on the device, and ``enqueue`` queues the
copy of their counts into pinned host memory; ``get`` waits for the
counts, copies only those rows into pinned host memory, waits again and
copies them out into arrays of the result's own: two waits, whatever the
capacity.
``enqueue_batch`` runs F same-sized frames as one batched extraction and
returns one job per frame; ``calibrate`` pins per-octave capacities for
later calls on that frame size. ``FeaturesDev.match`` ratio-test matches
two device results where they lie.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .config import SiftConfig
from .ops.matching import MatchResult, match_descriptors
from .ops.pyramid import FRONTS
from .pipeline import (DETECT_ROUTES, ExtractPlan, SiftFeatures,
                       build_extract_plan, calibrate_plan, extract_batch,
                       frame_features, packed_offsets, saturation_messages,
                       saturation_report, unpack_kept)
from .utils.device import resolve_device
from .utils.profiling import (count, queue_to_host, span, stream_mark,
                              to_host, tracing, wait)


@dataclass
class Feature:
    """One keypoint with its orientations and descriptors
    (features.h:22-34)."""

    x: float
    y: float
    sigma: float
    octave: int
    num_ori: int
    orientations: np.ndarray   # [num_ori]
    descriptors: np.ndarray    # [num_ori, 128]

    def print(self, stream, write_as_uchar: bool = False):
        """Reference text format: ``x y 1/s^2 0 1/s^2 d0..d127`` per
        orientation (Feature::print, features.cu:308-328), character for
        character as popsift_tpu.api.Feature.print."""
        sigval = 1.0 / (self.sigma * self.sigma)
        for o in range(self.num_ori):
            stream.write(f"{self.x} {self.y} {sigval} 0 {sigval} ")
            d = self.descriptors[o]
            if write_as_uchar:
                stream.write(" ".join(str(int(round(v))) for v in d))
            else:
                stream.write(" ".join(f"{v:.3g}" for v in d))
            stream.write(" \n")


HOST_FIELDS = ("x", "y", "sigma", "octave", "num_ori", "orientations",
               "ori_valid", "descriptors", "desc_to_kp")


class FeaturesHost:
    """Compacted host-side result (FeaturesHost, features.h:65-98):
    keypoints with at least one orientation, their descriptors and the
    descriptor -> keypoint map, as numpy arrays. Made from the padded
    result ``raw``, read whole and compacted here, or from the kept rows
    already on the host, a dict by field name (:data:`HOST_FIELDS`)."""

    def __init__(self, raw: SiftFeatures | dict):
        if isinstance(raw, dict):
            arrays = raw
        else:
            with span("copy"):
                r = {k: to_host(v) for k, v in raw._asdict().items()}
            with span("compact"):
                arrays = _compact(r)
        for k in HOST_FIELDS:
            setattr(self, k, arrays[k])
        if tracing():
            count("rows_valid.desc", len(self.descriptors))
            count("d2h_bytes_kept", sum(arrays[k].nbytes
                                        for k in HOST_FIELDS))

    def getFeatureCount(self) -> int:
        return int(len(self.x))

    def getDescriptorCount(self) -> int:
        return int(self.descriptors.shape[0])

    def features(self):
        """Iterate compacted :class:`Feature` records, descriptors grouped
        by keypoint in orientation order."""
        by_kp = {}
        for di, kp in enumerate(self.desc_to_kp):
            by_kp.setdefault(int(kp), []).append(di)
        for i in range(len(self.x)):
            rows = by_kp.get(i, [])
            n = len(rows)
            yield Feature(
                x=float(self.x[i]), y=float(self.y[i]),
                sigma=float(self.sigma[i]), octave=int(self.octave[i]),
                num_ori=n,
                orientations=self.orientations[i][self.ori_valid[i]][:n],
                descriptors=self.descriptors[rows] if n else
                np.zeros((0, 128), np.float32))

    def print(self, stream, write_as_uchar: bool = False):
        """Every feature's :meth:`Feature.print` lines, in keypoint order."""
        for f in self.features():
            f.print(stream, write_as_uchar)

    def save(self, path: str, write_as_uchar: bool = False):
        """Write the reference text format (features.cu:308-328), one line
        per descriptor, with the native writer."""
        from .runtime import native
        order = np.lexsort((np.arange(len(self.desc_to_kp)),
                            self.desc_to_kp))
        kp = self.desc_to_kp[order]
        native.write_features(
            path, self.x[kp], self.y[kp], self.sigma[kp],
            self.descriptors[order], write_as_uchar=write_as_uchar)


def _compact(r: dict) -> dict:
    """The kept rows of a padded result on the host, by field name."""
    kp_rows = np.nonzero(r["valid"])[0]
    kp_rows = kp_rows[r["num_ori"][kp_rows] > 0]
    d_rows = np.nonzero(r["desc_valid"])[0]
    remap = -np.ones(r["x"].shape[0], np.int64)
    remap[kp_rows] = np.arange(len(kp_rows))
    return dict(x=r["x"][kp_rows], y=r["y"][kp_rows],
                sigma=r["sigma"][kp_rows], octave=r["octave"][kp_rows],
                num_ori=r["num_ori"][kp_rows],
                orientations=r["ori"][kp_rows],
                ori_valid=r["ori_valid"][kp_rows],
                descriptors=r["desc"][d_rows],
                desc_to_kp=remap[r["desc_kp"][d_rows]])


class FeaturesDev:
    """Device-resident result (FeaturesDev, features.h:100-118): keeps the
    raw capacity-padded tensors."""

    def __init__(self, raw: SiftFeatures):
        self.raw = raw

    @property
    def descriptors(self) -> torch.Tensor:
        return self.raw.desc

    @property
    def desc_valid(self) -> torch.Tensor:
        return self.raw.desc_valid

    def getFeatureCount(self) -> int:
        return int(to_host(self.raw.n_keypoints))

    def getDescriptorCount(self) -> int:
        return int(to_host(self.raw.n_descriptors))

    def match(self, other: "FeaturesDev") -> MatchResult:
        """Ratio-test match of these descriptors against ``other``'s
        (FeaturesDev::match, features.cu:163-302) on their device: one
        row per capacity-padded row here, indices into ``other``'s
        padded rows (:func:`popsift_tpu_torch.ops.matching
        .match_descriptors`)."""
        return match_descriptors(self.raw.desc, self.raw.desc_valid,
                                 other.raw.desc, other.raw.desc_valid)


class SiftJob:
    """Extraction handle (SiftJob, popsift.h:40-71): ``get`` returns
    FeaturesHost in extracting mode and FeaturesDev in matching mode.
    ``request`` is the id of the traced request that made the job (None
    when tracing was off): the spans of its ``get`` belong to it.
    ``packed`` is what ``PopSift.enqueue`` queued for the host copy: the
    job's :class:`~popsift_tpu_torch.pipeline.Packed` rows on the
    device, their header's host copy and the mark that copy completes
    at; ``getHost`` then copies only the kept rows."""

    def __init__(self, raw: SiftFeatures, plan: ExtractPlan | None = None,
                 mode: str = "extracting", request: int | None = None,
                 packed: tuple | None = None):
        self._raw = raw
        self._plan = plan
        self._mode = mode
        self._request = request
        self._packed = packed
        self._host = None
        self._warned = False

    def _check_saturation(self, header: np.ndarray | None = None):
        """Warn once when an octave saturated its capacity or dropped
        candidates in the compaction (a job made without its plan has
        no capacities to check), from the packed ``header`` where given,
        else from counts read off the device."""
        if self._warned or self._plan is None:
            return
        self._warned = True
        if header is None:
            with span("check"):
                msgs = saturation_report(self._raw, self._plan)
        else:
            n = len(self._plan.ext_caps)
            msgs = saturation_messages(header[2:2 + n], header[2 + n:],
                                       self._plan)
        for msg in msgs:                # at the caller of getHost/getDev
            warnings.warn(msg, RuntimeWarning,
                          stacklevel=3 if header is None else 4)

    @property
    def raw(self) -> SiftFeatures:
        """The capacity-padded result tensors, on the run's device."""
        return self._raw

    def get(self):
        if self._mode == "matching":
            return self.getDev()
        return self.getHost()

    def getHost(self) -> FeaturesHost:
        if self._host is None:
            with span("get", request=self._request):
                if self._packed is None:
                    self._check_saturation()
                    self._host = FeaturesHost(self._raw)
                else:
                    self._host = self._packed_host()
                    self._packed = None
        return self._host

    def _packed_host(self) -> FeaturesHost:
        """The kept rows in two waits: for the header's counts, then for
        the copy of the packed prefix that holds them into pinned host
        memory, from which the arrays are copied out."""
        rows, header, ready = self._packed
        with span("check"):
            wait(ready)
            head = header.numpy()
            self._check_saturation(head)
        n_kp, n_desc = int(head[0]), int(head[1])
        with span("copy"):
            data = queue_to_host(rows.data[:packed_offsets(n_kp, n_desc)[1]])
            wait(stream_mark(rows.data.device))
        with span("compact"):
            count("frames.packed")
            # copied out, so that the pinned block goes back to the caching
            # allocator for the next get: results that kept pinned memory
            # would each need a fresh pinned allocation, whose cost grows
            # with the pinned memory held (1.4 ms a 1080p frame and more
            # on an H100's host)
            return FeaturesHost(unpack_kept(data.numpy().copy(), n_kp,
                                            n_desc))

    def getDev(self) -> FeaturesDev:
        with span("get", request=self._request):
            self._check_saturation()
            return FeaturesDev(self._raw)


def _check_image(image: np.ndarray, who: str) -> np.ndarray:
    if image.ndim != 2:
        raise ValueError(f"{who} expects [H, W] images")
    if image.dtype not in (np.uint8, np.float32):
        raise TypeError(f"{who} expects uint8 or float32 grayscale images")
    return image


class PopSift:
    """Extraction pipeline owner (PopSift, popsift.h:73-167) on one
    device. mode: "extracting" returns host features from jobs,
    "matching" keeps them on the device (ProcessingMode,
    sift_conf.h:87-90). ``device`` is "cuda" (the default), "cuda:N" or
    "cpu"; a CUDA device on a machine without one raises here.
    ``detect`` ("fused", the default, or "windows") and ``front``
    ("level", the default, or "chain") choose the detection route and
    the pyramid front of every extraction and of the calibration probe
    (:mod:`popsift_tpu_torch.pipeline`); all give the same features."""

    def __init__(self, config: SiftConfig | None = None,
                 mode: str = "extracting", device="cuda",
                 detect: str = "fused", front: str = "level"):
        if mode not in ("extracting", "matching"):
            raise ValueError(f"bad mode {mode!r}")
        if detect not in DETECT_ROUTES or front not in FRONTS:
            raise ValueError(f"bad route detect={detect!r}, front={front!r}")
        self._routes = dict(detect=detect, front=front)
        self._config = config or SiftConfig()
        self._mode = mode
        self.device = resolve_device(device)
        self._plans: dict = {}
        self._lock = threading.Lock()

    def configure(self, config: SiftConfig, force: bool = False) -> bool:
        """Adopt a new configuration; drops the plans, with their CUDA
        graphs, if it changed (PopSift::configure, popsift.cpp:63-87)."""
        if not force and config == self._config:
            return True
        with self._lock:
            self._config = config
            self._plans.clear()
        return True

    def _plan_for(self, h: int, w: int) -> ExtractPlan:
        key = (h, w, self._config)
        with self._lock:
            if key not in self._plans:
                self._plans[key] = build_extract_plan(self._config, h, w)
            return self._plans[key]

    def calibrate(self, frames, headroom: float = 1.5) -> ExtractPlan:
        """Pin per-octave capacities from representative frames
        (:func:`popsift_tpu_torch.pipeline.calibrate_plan`, probed on this
        PopSift's device); later ``enqueue``/``enqueue_batch`` calls on
        the same frame size use the calibrated plan."""
        frames = [np.asarray(f) for f in frames]
        h, w = frames[0].shape[-2:]
        plan = calibrate_plan(self._config, frames, h, w, headroom=headroom,
                              device=self.device, front=self._routes["front"])
        with self._lock:
            self._plans[(h, w, self._config)] = plan
        return plan

    def enqueue(self, image) -> SiftJob:
        """Submit a grayscale image: uint8 [H, W] or float32 [H, W] in
        [0, 1] (ImageFloat mode, s_image.cu:264-293). Returns after the
        image is on the device and the extraction is queued, without
        waiting for the card (popsift_tpu.api.PopSift.enqueue "returns
        immediately"); the job's ``get`` waits."""
        with span("enqueue") as s:
            image = _check_image(np.asarray(image), "enqueue")
            return self._submit(image[None], s.request)[0]

    def enqueue_batch(self, images) -> list:
        """Submit F same-sized grayscale frames as one batched extraction
        (:func:`popsift_tpu_torch.pipeline.extract_batch`); returns one
        SiftJob per frame, all sharing that run (popsift_tpu.api
        .PopSift.enqueue_batch). Each frame's result equals its own
        ``enqueue``."""
        with span("enqueue") as s:
            imgs = [_check_image(np.asarray(im), "enqueue_batch")
                    for im in images]
            if not imgs or any(im.shape != imgs[0].shape
                               or im.dtype != imgs[0].dtype for im in imgs):
                raise ValueError("enqueue_batch expects F >= 1 frames of one "
                                 "shape and type")
            return self._submit(np.stack(imgs), s.request)

    def _submit(self, frames: np.ndarray, request) -> list:
        """One extraction of ``frames`` [F, H, W] and a job a frame. In
        extracting mode it also packs the kept rows, and the header of
        their counts is copied to pinned host memory behind it."""
        plan = self._plan_for(*frames.shape[1:])
        F = len(frames)
        if self._mode == "matching":
            out = extract_batch(frames, plan, self.device, **self._routes)
            return [SiftJob(frame_features(out, f), plan, mode=self._mode,
                            request=request) for f in range(F)]
        out, packed = extract_batch(frames, plan, self.device, pack=True,
                                    **self._routes)
        header = queue_to_host(packed.header)
        ready = stream_mark(self.device)
        return [SiftJob(frame_features(out, f), plan, request=request,
                        packed=(frame_features(packed, f), header[f], ready))
                for f in range(F)]

    def uninit(self):
        """Drop the plans with their CUDA graphs."""
        with self._lock:
            self._plans.clear()

    # Deprecated blocking API (PopSift::init/execute, popsift.h:122-139),
    # kept for callers from before the job pipeline.

    def init(self, w: int, h: int) -> bool:
        """Deprecated: plan for a w x h image (popsift.h:122-131). The job
        API plans on the first ``enqueue``; this makes that plan now."""
        warnings.warn("PopSift.init is deprecated; use enqueue()",
                      DeprecationWarning, stacklevel=2)
        self._plan_for(h, w)
        return True

    def execute(self, image):
        """Deprecated blocking extraction (popsift.h:133-139): ``enqueue``
        and ``get`` in one call."""
        warnings.warn("PopSift.execute is deprecated; use enqueue()",
                      DeprecationWarning, stacklevel=2)
        return self.enqueue(image).get()
