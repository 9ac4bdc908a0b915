"""The extraction path on the card at 1080p: the main path, the batch
path and calibration, the other routes and the entries no path calls,
and the extraction variants.

These tests need a CUDA device (and nvcc, to build popsift_tpu_torch/csrc
on first use); they skip without one. On the card:

    python -m pytest tests/test_torch_pipeline_cuda.py -q --noconftest -m cuda

The frames are ``bench.make_frame`` at 1920 x 1080, seeds 0-3, with
``SiftConfig(extrema_capacity=8192)``: frame 0 gives 2110 keypoints and
2505 descriptors with no candidate dropped. A frame of a batch or of
another route is held to its own ``enqueue`` by one rule
(:func:`same_field`): integer and bool fields exact, float fields
bit-equal or within 1e-6 x the field's magnitude. A variant's kernels
are held to its ``plain=True`` run on the card (:func:`same_features`):
masks and counts exact, x, y and sigma bit-equal, orientations and
descriptors within the golden tolerances. Each path's first call
launches exactly the kernel entries its configuration and route call
for (:func:`test_first_call_launches`).
"""

import warnings

import numpy as np
import pytest
import torch

from popsift_tpu_torch.api import PopSift
from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.pipeline import (build_extract_plan, extract,
                                        extract_batch)
from torch_card import (BENCH_DESCRIPTORS, BENCH_KEYPOINTS, FRAME_HW,
                        GOLDEN_TOL, N_FRAMES, PROBE_PATH, card_device,
                        expected_launches, launches_of, per_octave_chain,
                        rel_row_err, without_syncs)

pytestmark = pytest.mark.cuda

# the extraction variants on the bench frame, each a set of SiftConfig
# keywords beside extrema_capacity=8192
VARIANTS = {
    "vlfeat_igrid": dict(sift_mode="vlfeat", desc_mode="igrid",
                         norm_mode="classic"),
    "grid_fixed9": dict(gauss_mode="fixed9", desc_mode="grid"),
    "iloop_interp": dict(desc_mode="iloop", downscale_mode="interpolate"),
    "sift_opencv": dict(sift_mode="opencv"),
    "direct": dict(scaling_mode="direct"),
    "relative_all": dict(gauss_mode="vlfeat-relative-all"),
    "fixed15": dict(gauss_mode="fixed15"),
    "upscale0": dict(upscale_factor=0.0),
    "filter_largest": dict(filter_max_extrema=1000, filter_grid_size=2,
                           grid_filter_mode="largest"),
    "filter_smallest": dict(filter_max_extrema=1000, filter_grid_size=2,
                            grid_filter_mode="smallest"),
    "filter_random": dict(filter_max_extrema=1000, filter_grid_size=2,
                          grid_filter_mode="random"),
}
# driven through enqueue_batch of the four frames on the window route
# (loop descriptors: a plain-torch variant costs 0.25-1 s a frame)
BATCH_VARIANT = dict(downscale_mode="interpolate",
                     gauss_mode="vlfeat-relative-all",
                     filter_max_extrema=1000)
# held against the port's CPU run on a 480 x 640 crop of the bench frame
CPU_VARIANT = dict(sift_mode="opencv", gauss_mode="fixed15",
                   downscale_mode="interpolate", filter_max_extrema=300)
INT_FIELDS = ("octave", "num_ori", "valid", "ori_valid", "desc_kp",
              "desc_valid", "n_keypoints", "n_descriptors",
              "octave_candidates", "octave_dropped")


@pytest.fixture(scope="module")
def card():
    """The card, the four bench frames and the main path's configuration."""
    dev = card_device()
    import bench
    return dict(dev=dev,
                frames=[bench.make_frame(*FRAME_HW, seed=s)
                        for s in range(N_FRAMES)],
                cfg=SiftConfig(extrema_capacity=8192))


@pytest.fixture(scope="module")
def base_jobs(card):
    """Each frame through ``enqueue`` on the default route."""
    ps = PopSift(card["cfg"], device=card["dev"])
    jobs = [ps.enqueue(f) for f in card["frames"]]
    for j in jobs:
        j.get()
    return jobs


def is_bench_frame(host, raw) -> bool:
    return (host.getFeatureCount() == BENCH_KEYPOINTS
            and host.getDescriptorCount() == BENCH_DESCRIPTORS
            and not raw.octave_dropped.any())


def same_field(name, a, b) -> None:
    """One field of a frame against its ``enqueue`` run: integer and bool
    fields exact, float fields bit-equal or within 1e-6 x the field's
    magnitude."""
    assert a.shape == b.shape and a.dtype == b.dtype, name
    if torch.equal(a, b):
        return
    assert a.is_floating_point(), name
    diff, mag = float((a - b).abs().max()), float(b.abs().max())
    assert diff <= 1e-6 * mag, (name, diff, mag)


def same_features(got, ref, desc_mode: str, tol: dict | None = None):
    """``got`` against ``ref`` (SiftFeatures of the same frames): masks,
    counts and the other integer fields exact, then x, y, sigma,
    orientations and descriptors within ``tol`` (default: the kernels'
    run against the plain run on the card, x, y and sigma bit-equal, K2
    and K5 being bit-equal to their plain versions, orientations and
    descriptors within the golden tolerances, since K3's summation order
    moves an angle in its last bits and the descriptor with it; a
    plain-torch descriptor variant's rows whose angles are bit-equal
    must be bit-equal)."""
    for name in INT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape and torch.equal(a, b), name
    valid, dvalid, ov = ref.valid, ref.desc_valid, ref.ori_valid
    diff = lambda a, b, m: float((a - b)[m].abs().max()) if bool(m.any()) \
        else 0.0
    err = {k: diff(getattr(got, k), getattr(ref, k), valid)
           for k in ("x", "y", "sigma")}
    err["ori"] = diff(got.ori, ref.ori, ov)
    err["desc"] = diff(got.desc, ref.desc, dvalid)
    if tol is None:
        tol = dict(x=0.0, y=0.0, sigma=0.0, ori=GOLDEN_TOL["ori"],
                   desc=GOLDEN_TOL["desc"])
        if desc_mode != "loop":
            same = (got.ori == ref.ori).all(-1).gather(-1, got.desc_kp) \
                & dvalid
            assert torch.equal(got.desc[same], ref.desc[same])
    for k, t in tol.items():
        assert (err[k] <= t if t == 0.0 else err[k] < t), (k, err[k], t)


def held_kernels(run) -> None:
    """Run ``run()`` (an eager extraction: a plan's first) with K3's and
    (for ``desc_mode="loop"``) K4's calls of the pipeline held to their
    plain versions on the same inputs, rows within 1e-5 x the row's
    max."""
    import popsift_tpu_torch.pipeline as P
    real_o = P._ori.orientation_histograms_octaves
    real_d = P._desc.compute_descriptors_octaves
    rel = {"K3": [], "K4": []}

    def ori(blurs, ext, cfg_, row_ends, F=1, plain=False):
        k = real_o(blurs, ext, cfg_, row_ends, F, plain)
        rel["K3"].append(rel_row_err(
            k, real_o(blurs, ext, cfg_, row_ends, F, True)))
        return k

    def desc(blurs, jobs, row_ends, cfg_, plain=False):
        k = real_d(blurs, jobs, row_ends, cfg_, plain)
        if cfg_.desc_mode == "loop":
            rel["K4"].append(rel_row_err(
                k, real_d(blurs, jobs, row_ends, cfg_, True)))
        return k

    P._ori.orientation_histograms_octaves = ori
    P._desc.compute_descriptors_octaves = desc
    try:
        run()
    finally:
        P._ori.orientation_histograms_octaves = real_o
        P._desc.compute_descriptors_octaves = real_d
    assert rel["K3"], "K3 was not called"
    for name, r in rel.items():
        assert max(r, default=0.0) <= 1e-5, (name, r)


def test_main_path_on_the_bench_frame(card, base_jobs):
    """``PopSift(SiftConfig(extrema_capacity=8192)).enqueue(frame).get()``
    on frame 0: 2110 keypoints / 2505 descriptors, no dropped candidate,
    finite outputs; then ``extract`` of the frame already on the card,
    its first call eager and its second (which captures the graph) under
    sync debug mode "error", equal to the enqueued run in every field."""
    dev, frame = card["dev"], card["frames"][0]
    job = base_jobs[0]
    host, raw = job.get(), job.raw
    assert raw.octave_dropped.tolist() == [0] * len(raw.octave_dropped)
    assert is_bench_frame(host, raw)
    for k in ("x", "y", "sigma", "orientations", "descriptors"):
        assert np.isfinite(getattr(host, k)).all(), k
    assert host.descriptors.shape == (BENCH_DESCRIPTORS, 128)
    plan = build_extract_plan(card["cfg"], *frame.shape)
    uploaded = torch.from_numpy(frame).to(dev)
    extract(uploaded, plan, dev)
    got = without_syncs(lambda: extract(uploaded, plan, dev))
    for name, a, b in zip(got._fields, got, raw):
        assert a.shape == b.shape and torch.equal(a, b), name


def test_batch_path_equals_enqueue(card):
    """``enqueue_batch`` of the four frames: each frame equal to its own
    ``enqueue`` by :func:`same_field`, frame 0 2110 / 2505 with nothing
    dropped; ``extract_batch`` of the frames on the card, its capture
    under sync debug mode "error", equal to a fresh plan's run in every
    field."""
    dev, frames, cfg = card["dev"], card["frames"], card["cfg"]
    ps = PopSift(cfg, device=dev)
    jobs = ps.enqueue_batch(frames)
    hosts = [j.get() for j in jobs]
    for f, (frame, job, host) in enumerate(zip(frames, jobs, hosts)):
        one = ps.enqueue(frame)
        single = one.get()
        assert host.getFeatureCount() == single.getFeatureCount(), f
        assert host.getDescriptorCount() == single.getDescriptorCount(), f
        for k, a, b in zip(job.raw._fields, job.raw, one.raw):
            same_field(f"frame {f} {k}", a, b)
    assert is_bench_frame(hosts[0], jobs[0].raw)
    imgs = np.stack(frames)
    uploaded = torch.from_numpy(imgs).to(dev)
    plan = build_extract_plan(cfg, *frames[0].shape)
    want = extract_batch(imgs, build_extract_plan(cfg, *frames[0].shape),
                         dev)
    extract_batch(uploaded, plan, dev)
    got = without_syncs(lambda: extract_batch(uploaded, plan, dev))
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


def test_calibrate_leaves_no_octave_saturated(card):
    """``PopSift.calibrate([frame])`` of ``SiftConfig()``, then ``enqueue``
    of that frame: no octave reaches its calibrated capacity, and no
    saturation warning."""
    dev, frames = card["dev"], card["frames"]
    ps = PopSift(SiftConfig(), device=dev)
    cal = ps.calibrate(frames[:1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        job = ps.enqueue(frames[0])
        job.get()
    cand = job.raw.octave_candidates.tolist()
    assert all(c < cap for c, cap in zip(cand, cal.ext_caps)), \
        (cand, cal.ext_caps)
    assert not [w for w in caught if "saturated" in str(w.message)]


@pytest.mark.parametrize("batch,route", [
    (False, dict(detect="windows")), (True, dict(detect="windows")),
    (False, dict(front="chain")), (True, dict(front="chain")),
    (False, dict(detect="windows", front="chain"))],
    ids=["windows", "windows_batch", "chain", "chain_batch",
         "windows_chain"])
def test_route_equals_the_default_route(card, base_jobs, batch, route):
    """The window detection route and the chain front at full width, one
    frame or the four through ``enqueue_batch``: 2110 / 2505 on frame 0
    with nothing dropped, every frame equal to its ``detect="fused"``,
    ``front="level"`` result by :func:`same_field`, finite
    descriptors."""
    frames = card["frames"]
    ps = PopSift(card["cfg"], device=card["dev"], **route)
    jobs = ps.enqueue_batch(frames) if batch else [ps.enqueue(frames[0])]
    hosts = [j.get() for j in jobs]
    assert is_bench_frame(hosts[0], jobs[0].raw)
    for f, job in enumerate(jobs):
        for k, a, b in zip(job.raw._fields, job.raw, base_jobs[f].raw):
            same_field(f"frame {f} {k}", a, b)
        assert np.isfinite(hosts[f].descriptors).all(), f


def test_entries_off_every_path(card, base_jobs):
    """The entries no extraction path calls, driven on the densest
    octave's rows of frame 0: the bucketed K3 and K4 and the patch entry
    of K4 (finite, the expected shapes, no empty row for a valid
    keypoint); K2's single-octave and batched entries equal to that
    octave's rows of its all-octave launch; K1's single-octave and
    batched entries equal."""
    from popsift_tpu_torch.ops import descriptors as D
    from popsift_tpu_torch.ops import extrema as E
    from popsift_tpu_torch.ops import orientation as O
    from popsift_tpu_torch.ops import patches as PT
    from popsift_tpu_torch.ops.kernels import (desc, extrema_mask, orient,
                                               refine)
    from popsift_tpu_torch.ops.pyramid import build_pyramid
    dev, cfg, frames = card["dev"], card["cfg"], card["frames"]
    plan = build_extract_plan(cfg, *frames[0].shape)
    raw = base_jobs[0].raw
    od = int(raw.octave_candidates.argmax())
    offs = np.concatenate([[0], np.cumsum(plan.ext_caps)]).astype(int)
    sl = slice(offs[od], offs[od + 1])
    blurs, dogs = build_pyramid(torch.from_numpy(frames[0]).to(dev),
                                plan.pyramid)
    scale = 2.0 ** (od - cfg.upscale_factor)
    kx, ky, ks = (raw.x[sl] / scale, raw.y[sl] / scale, raw.sigma[sl] / scale)
    level = torch.round(torch.log2(ks.clamp(min=1e-6) / cfg.sigma)
                        * cfg.levels).long()
    valid = raw.valid[sl] & (raw.num_ori[sl] > 0)   # the octave's keypoints
    split = cfg.sigma * 2.0 ** (2.5 / cfg.levels)
    radius = D.loop_patch_radius(cfg)
    hist = orient.orientation_hist_bucketed(
        blurs[od], kx, ky, ks, level, valid, O.max_ori_radius(cfg), split,
        int(round(4.5 * split)))
    ang = raw.ori[sl][:, 0]
    dsc = desc.descriptor_loop_bucketed(
        blurs[od], kx, ky, ks, level, ang, valid, radius, split,
        int(np.ceil(2.5 * 2.0 ** 0.5 * 3.0 * split)) + 2)
    rows = valid.nonzero().squeeze(1)
    prow = -(-(2 * radius + 1) // 8) * 8
    pcol = -(-(2 * radius + 1) // 128) * 128
    pt, py0, px0 = PT.extract_patches_rect(
        PT.pad_for_patches(blurs[od], max(prow, pcol)), level[rows],
        torch.round(ky[rows]).long(), torch.round(kx[rows]).long(), prow,
        pcol, radius, radius)
    dpt = desc.descriptor_loop_patches(pt, py0, px0, kx[rows], ky[rows],
                                       ks[rows], ang[rows], valid[rows],
                                       *plan.pyramid.dims[od])
    assert hist.shape == (valid.numel(), 36)
    assert dsc.shape == (valid.numel(), 128)
    assert dpt.shape == (rows.numel(), 128)
    for t in (hist, dsc, dpt):
        assert torch.isfinite(t).all()
    assert (hist[valid].sum(1) > 0).all() and (dpt.sum(1) > 0).all()
    assert (dsc[valid].sum(1) > 0).all()

    cap = plan.ext_caps[od]
    cand = E.collect_candidates(dogs[od], cfg, cap)
    kw = dict(maxlevel=cfg.total_levels - 1,
              vlfeat=cfg.sift_mode == "vlfeat")
    one = refine.refine_state(dogs[od], cand.x0, cand.y0, cand.z0,
                              int(cand.n_found), **kw)
    pair = E.collect_refined_batched(torch.cat([dogs[od], dogs[od]]), 2, cfg,
                                     cap)
    rows_o = E.compact_octaves(E.candidate_masks(dogs, cfg), cfg,
                               plan.ext_caps)
    full = E.refine_octaves(dogs, rows_o, cfg, plan.ext_caps)
    assert torch.equal(one, full[sl])
    assert torch.equal(pair.vals[:cap], one)
    assert torch.equal(pair.vals[cap:], one)
    thr1 = float(np.float32(E._first_threshold(cfg)))
    m1 = extrema_mask.candidate_mask(dogs[od], thr1)
    m2 = extrema_mask.candidate_mask_batched(
        torch.cat([dogs[od], dogs[od]]), 2, thr1)
    assert m1.any() and torch.equal(m2[0], m1) and torch.equal(m2[1], m1)


@pytest.mark.parametrize("name", ["default", *VARIANTS, "batch_windows"])
def test_variant_equals_its_plain_run(card, name):
    """A variant of ``SiftConfig(extrema_capacity=8192)`` through
    ``enqueue`` of frame 0 (or ``enqueue_batch`` of the four frames on the
    window route): each frame equal to ``extract_batch`` of the frames
    on the card; that run equal to its ``plain=True`` run
    (:func:`same_features`); K3's and K4's rows of an eager run within
    1e-5 x the row's max of their plain versions on the same inputs; the
    run again, under sync debug mode "error", equal; finite outputs."""
    dev = card["dev"]
    batch = name == "batch_windows"
    detect = "windows" if batch else "fused"
    kw = BATCH_VARIANT if batch else VARIANTS.get(name, {})
    cfg = SiftConfig(extrema_capacity=8192, **kw)
    fr = card["frames"] if batch else card["frames"][:1]
    plan = build_extract_plan(cfg, *fr[0].shape)
    ps = PopSift(cfg, device=dev, detect=detect)
    jobs = ps.enqueue_batch(fr) if batch else [ps.enqueue(fr[0])]
    hosts = [j.get() for j in jobs]
    uploaded = torch.from_numpy(np.stack(fr)).to(dev)

    def run(plain=False):
        return extract_batch(uploaded, plan, dev, plain=plain, detect=detect)

    got = run()
    for f, job in enumerate(jobs):
        for k, a, b in zip(job.raw._fields, job.raw, got):
            assert torch.equal(a, b[f]), (f, k)
    same_features(got, run(plain=True), cfg.desc_mode)
    # on a plan of its own: its first run is eager, so the held kernels'
    # plain versions run beside them (a replay runs neither)
    held_kernels(lambda: extract_batch(
        uploaded, build_extract_plan(cfg, *fr[0].shape), dev, detect=detect))
    again = without_syncs(run)
    for k, a, b in zip(got._fields, again, got):
        assert torch.equal(a, b), k
    for h in hosts:
        for k in ("x", "y", "sigma", "descriptors"):
            assert np.isfinite(getattr(h, k)).all(), k


def test_variant_on_a_crop_equals_the_cpu(card):
    """``CPU_VARIANT`` on a 480 x 640 crop of frame 0: the card against the
    port's CPU run, masks and counts exact, the rest within the golden
    tolerances."""
    frame = card["frames"][0]
    h, w = frame.shape
    y0, x0 = max(0, (h - 480) // 2), max(0, (w - 640) // 2)
    crop = np.ascontiguousarray(frame[y0:y0 + 480, x0:x0 + 640])
    cfg = SiftConfig(extrema_capacity=1024, **CPU_VARIANT)
    cplan = build_extract_plan(cfg, *crop.shape)
    on_card = extract_batch(crop[None], cplan, card["dev"])
    on_cpu = extract_batch(crop[None], cplan, torch.device("cpu"))
    same_features(type(on_cpu)(*(a.cpu() for a in on_card)), on_cpu,
                  cfg.desc_mode, tol=dict(GOLDEN_TOL))


@pytest.mark.parametrize("F", [1, 2, 8])
def test_batch_sizes(card, F):
    """``extract_batch`` of F bench frames (seeds 0..F-1): frame 0 gives
    2110 / 2505."""
    import bench
    dev = card["dev"]
    plan = build_extract_plan(card["cfg"], *FRAME_HW)
    up = torch.from_numpy(np.stack([bench.make_frame(*FRAME_HW, seed=s)
                                    for s in range(F)])).to(dev)
    res = extract_batch(up, plan, dev)
    assert (int(res.n_keypoints[0]), int(res.n_descriptors[0])) \
        == (BENCH_KEYPOINTS, BENCH_DESCRIPTORS)


# each path's first call through a fresh PopSift: case -> (SiftConfig
# keywords beside extrema_capacity=8192, PopSift's route keywords, the
# four frames through enqueue_batch)
LAUNCH_CASES = {
    "main": ({}, {}, False),
    "batch": ({}, {}, True),
    "windows": ({}, dict(detect="windows"), False),
    "windows_batch": ({}, dict(detect="windows"), True),
    "chain": ({}, dict(front="chain"), False),
    "chain_batch": ({}, dict(front="chain"), True),
    "windows_chain": ({}, dict(detect="windows", front="chain"), False),
    **{f"variant_{n}": (kw, {}, False) for n, kw in VARIANTS.items()},
    "variant_batch_windows": (BATCH_VARIANT, dict(detect="windows"), True),
}


@pytest.mark.parametrize("case", [*LAUNCH_CASES, "probe", "match",
                                  "per_octave_chain"])
def test_first_call_launches(card, case):
    """The kernel entries a path's first call launches
    (:func:`torch_card.launches_of`, on a fresh ``PopSift`` or plan: a
    replay makes no wrapper call): every entry exactly as
    :func:`torch_card.expected_launches` of the case's configuration
    and route, so on the default configuration K5 30 times (five levels
    of six wide octaves) and K7 12 times on the chain front; the
    calibration probe the same front and detection (K5, K1, the
    compaction) and nothing after it; the matching mode's two frames
    (the eager call and the capture) twice the main path and their match
    the matcher's kernel once; the per-octave chain (a second run: its first makes the constants) K1's
    single-octave entry, the compaction, K2's all-octave entry and K3's
    single-octave entry once per octave, K4's single-octave entry once
    per octave with jobs (9 and 6 at 1080p), K5 at least once and no
    other all-octave entry."""
    dev, frames = card["dev"], card["frames"]
    cfg = card["cfg"]
    plan = build_extract_plan(cfg, *FRAME_HW)
    if case == "probe":
        _, launches = launches_of(lambda: PopSift(SiftConfig(), device=dev)
                               .calibrate(frames[:1]))
        want = {k: v if k in PROBE_PATH else 0
                for k, v in expected_launches(cfg, plan).items()}
    elif case == "match":
        ps = PopSift(cfg, mode="matching", device=dev)
        shifted = np.roll(frames[0], (3, 5), axis=(0, 1))

        def pair():
            d0, ds = (ps.enqueue(f).get() for f in (frames[0], shifted))
            return d0.match(ds)

        _, launches = launches_of(pair)
        want = {k: 2 * v for k, v in expected_launches(cfg, plan).items()}
        want["match_top2"] = 1
    elif case == "per_octave_chain":
        uploaded = torch.from_numpy(frames[0]).to(dev)
        per_octave_chain(uploaded, plan)
        chain, launches = launches_of(lambda: per_octave_chain(uploaded,
                                                               plan))
        n_oct = len(plan.ext_caps)
        with_jobs = sum(int(c[2].count) > 0 for c in chain)
        assert (n_oct, with_jobs) == (9, 6)
        assert launches["blur_dog"] > 0
        want = dict(extrema_mask=n_oct, compact=n_oct, refine_octaves=n_oct,
                    orientation_hist=n_oct, descriptor_loop=with_jobs,
                    extrema_mask_octaves=0, refine=0,
                    orientation_hist_octaves=0, descriptor_loop_octaves=0)
        launches = {k: launches[k] for k in want}
    else:
        kw, route, batch = LAUNCH_CASES[case]
        cfg = SiftConfig(extrema_capacity=8192, **kw)
        ps = PopSift(cfg, device=dev, **route)
        fr = frames if batch else frames[:1]
        _, launches = launches_of(lambda: [j.get() for j in (
            ps.enqueue_batch(fr) if batch else [ps.enqueue(fr[0])])])
        want = expected_launches(cfg, build_extract_plan(cfg, *FRAME_HW),
                                 batch, **route)
    if case in ("main", "batch"):
        assert (launches["blur_dog"], launches["blur_dog_thin"]) == (30, 1)
    if case in ("chain", "chain_batch"):
        assert launches["blur_chain"] == 12
    assert launches == want
