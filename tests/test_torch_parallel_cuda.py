"""The multi-device layer on one card: data-parallel extraction with the
ring and all-pairs matches, distributed bundle adjustment and
edge-sharded averaging (``parallel/``, ``sfm/distributed.py``), and the
spatially sharded extraction (``parallel/spatial.py``), at world size 1
on NCCL and on two (and four) processes sharing the card on gloo.

These tests need a CUDA device; they skip without one. On the card:

    python -m pytest tests/test_torch_parallel_cuda.py -q --noconftest -m cuda

The ranks are processes started by ``parallel/launch.py::spawn``, which
import this module to run the ``*_rank`` functions. Every layer is held
to its single-process run: extraction by ``extract_batch`` (bit-equal
at world size 1) or ``extract``, and world size 2 by world size 1, with
integer and bool fields exact and float fields within 1e-6 x the
field's magnitude (:func:`check_gaps`); matches by
``match_descriptors`` bit for bit, BA by ``bundle_adjust``'s final cost
within ``BA_COST_TOL`` and its first f64 GN step within 1e-9 x its max,
the averaging by ``ROTATION_TOL`` and ``TRANSLATION_F32_TOL``. On the
sharded path the keypoints stay in global rows, so two world sizes are
compared in :func:`canonical` order.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from popsift_tpu_torch.config import SiftConfig
from popsift_tpu_torch.tools.sfm_scenes import ba_scene
from popsift_tpu_torch.tools.step_spread import (TRANSLATION_F32_TOL, _gap,
                                                 as_f64, step_scene)
from torch_card import (BENCH_DESCRIPTORS, BENCH_KEYPOINTS, BOUNDED,
                        FRAME_HW, FUSED_ONCE, MAIN_PATH, N_FRAMES,
                        SPATIAL_PATH, card_device, launches_of, rel_row_err,
                        without_syncs)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY = 8192
AP_ROWS = 4096        # all-pairs: each frame's first 4096 valid descriptors
AVG_NODES = 1000      # edge-sharded averaging: a chain plus 4 edges a node
BA_COST_TOL = 1e-3    # distributed BA's final cost against bundle_adjust's
ROTATION_TOL = 2e-4   # tests/test_sfm_distributed.py:229-236
FRAME_4K = (2160, 3840)
# per-octave capacity of the 4K runs: the densest 4K octave holds about
# four times the 1080p frame's 2005 candidates, and a band takes half
CAPACITY_4K = 32768


@pytest.fixture(scope="module")
def card():
    """The card and the inputs: the four bench frames, the BA problem and
    GN-step problem at the BA benchmark's size, the averaging graph."""
    dev = card_device("the ranks share the card")
    import bench
    frames = [bench.make_frame(*FRAME_HW, seed=s) for s in range(N_FRAMES)]
    return SimpleNamespace(
        dev=dev, frames=frames,
        fields=ba_scene(2, noise_px=0.5)[0], step_fields=step_scene(),
        graph=averaging_graph(AVG_NODES),
        frame4k=bench.make_frame(*FRAME_4K))


def averaging_graph(n: int = AVG_NODES, seed: int = 3) -> tuple:
    """tests/test_sfm_distributed.py:176-200's view graph at ``n`` nodes:
    rotations exp(N(0, 1)), centres U(-5, 5)^3, a chain plus 4n random
    edges (about 5 a node), exact relative rotations and unit
    directions. Returns (n, ei, ej, R_rel, d, the true centres)."""
    from popsift_tpu_torch.sfm.rotation import exp_so3
    rng = np.random.default_rng(seed)
    R_gt = exp_so3(torch.from_numpy(
        rng.normal(0, 1, (n, 3)).astype(np.float32))).numpy()
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ei, ej = list(range(n - 1)), list(range(1, n))
    for _ in range(4 * n):
        i, j = rng.integers(0, n, 2)
        if i != j:
            ei.append(min(i, j))
            ej.append(max(i, j))
    ei, ej = np.asarray(ei, np.int64), np.asarray(ej, np.int64)
    R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei]).astype(np.float32)
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return n, ei, ej, R_rel, d, C_gt


def allpairs_sets(feats, rows: int = AP_ROWS) -> tuple:
    """Each frame's first ``rows`` valid descriptor rows, padded with
    invalid zero rows: (desc f32[F, rows, 128], valid bool[F, rows])."""
    F = feats.desc.shape[0]
    desc = feats.desc.new_zeros((F, rows, 128))
    valid = torch.zeros((F, rows), dtype=torch.bool, device=desc.device)
    for f in range(F):
        idx = torch.nonzero(feats.desc_valid[f])[:rows, 0]
        desc[f, :len(idx)] = feats.desc[f, idx]
        valid[f, :len(idx)] = True
    return desc, valid


def ba_runs(mesh, fields: dict, step_fields: dict, dev) -> dict:
    """Distributed bundle adjustment of ``fields`` (dense and CG, 10
    iterations) on this rank's shard: final cost and the run itself
    (``fn``); the first GN step of each kind of ``step_fields`` in f64,
    gathered in the original point order."""
    from popsift_tpu_torch.parallel.mesh import axis_size, psum
    from popsift_tpu_torch.sfm import ba as B
    from popsift_tpu_torch.sfm import distributed as D
    n = axis_size(mesh)
    shard = D.shard_of(D.partition_by_point(
        B.problem_from_numpy(fields, dev), n)[0], mesh)
    out = {}
    for kind, kw in (("dense", dict(dense=True)), ("cg", dict(cg_iters=25))):
        fn = D.make_distributed_ba_fn(mesh, iters=10, **kw)
        res, costs = fn(shard)
        out[kind] = dict(cost=float(costs[-1]),
                         finite=bool(torch.isfinite(costs).all()),
                         fn=lambda fn=fn: fn(shard))
    part, idx = D.partition_by_point(B.problem_from_numpy(step_fields, dev), n)
    s64 = as_f64(D.shard_of(part, mesh))
    lam = s64.cams.new_full((), 1e-3)
    reduce = lambda x: psum(x, mesh)
    for kind, step in (("dense", lambda: B.schur_dense_step(
            s64, lam, reduce=reduce)), ("cg", lambda: B.schur_cg_step(
                s64, lam, cg_iters=25, reduce=reduce))):
        dc, dp, _ = step()
        out[f"step_{kind}"] = dict(
            dc=dc.cpu().numpy(),
            dp=D.gather_points(dp, mesh, idx).cpu().numpy())
    return out


def avg_solves(graph: tuple, dev, mesh=None) -> tuple:
    """Rotation averaging of ``graph`` and translation averaging in f32
    and f64, on one process or, with ``mesh``, with the edges sharded
    over it (``reduce=psum``): numpy (R, C, C in f64)."""
    from popsift_tpu_torch.parallel.mesh import psum
    from popsift_tpu_torch.sfm import distributed as D
    from popsift_tpu_torch.sfm import global_sfm as G
    n, ei, ej, R_rel, d = graph[:5]
    reduce = None if mesh is None else (lambda x: psum(x, mesh))
    t = lambda a: torch.from_numpy(a).to(dev)

    def edges(payload):
        if mesh is None:
            return t(ei), t(ej), t(payload), None
        return D.shard_edges(t(ei), t(ej), t(payload), None, mesh)
    ii, jj, R, v = edges(R_rel)
    out = [G.rotation_averaging(n, ii, jj, R, valid=v, reduce=reduce)[0]]
    for dd in (d, d.astype(np.float64)):
        ii, jj, dd, v = edges(dd)
        out.append(G.translation_averaging(n, ii, jj, dd, valid=v,
                                           reduce=reduce)[0])
    return tuple(x.cpu().numpy() for x in out)


def field_gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(same shape and dtype, bit-equal, float, max |a - b|, max |b|)."""
    ok = a.shape == b.shape and a.dtype == b.dtype
    eq = ok and bool(torch.equal(a, b))
    fl = a.is_floating_point()
    diff = float((a.double() - b.double()).abs().max()) if ok and fl and \
        a.numel() else 0.0
    return ok, eq, fl, diff, float(b.abs().max()) if fl and b.numel() else 0.0


def check_gaps(tag: str, gaps: dict) -> None:
    """Field gaps (:func:`field_gap`) within the batch path's rule:
    integer and bool fields exact, float fields bit-equal or within 1e-6
    x the field's magnitude."""
    for name, (ok, eq, fl, diff, mag) in gaps.items():
        assert ok, f"{tag} {name}: shape or dtype differs"
        assert eq or (fl and diff <= 1e-6 * mag), (tag, name, diff, mag)


def check_ba(tag: str, got: dict, step: dict, ref_cost: float,
             ref_step: tuple) -> None:
    """A distributed BA run's final cost within BA_COST_TOL of
    ``bundle_adjust``'s and its first f64 GN step within 1e-9 x the
    step's max of the single-process f64 step."""
    gap = abs(got["cost"] - ref_cost) / ref_cost
    assert got["finite"] and gap <= BA_COST_TOL, (tag, gap)
    for k, r in zip(("dc", "dp"), ref_step):
        assert _gap(torch.from_numpy(step[k]), r) <= 1e-9, (tag, k)


def check_avg(tag: str, got: tuple, ref: tuple) -> None:
    """The edge-sharded solves ``got`` (R, C, C in f64) against the
    single-process ``ref``: rotations within ROTATION_TOL, the f64
    translations within TRANSLATION_F32_TOL x the scale. The f32
    translations are not held: at this size the dense f32 solve (its
    gauge pinned by a 1e6 diagonal) moves with the last bits of its
    system, and its annealed IRLS carries that anywhere (ROADMAP C)."""
    scale = float(np.linalg.norm(ref[2] - ref[2].mean(0), axis=1).mean())
    assert float(np.abs(got[0] - ref[0]).max()) <= ROTATION_TOL, tag
    assert float(np.linalg.norm(got[2] - ref[2], axis=1).max()) / scale \
        <= TRANSLATION_F32_TOL, tag


def allpairs_equal(ap: dict, desc, valid) -> None:
    """Every (i, j) pair of an all-pairs result equals
    ``match_descriptors`` of that pair run alone, bit for bit."""
    from popsift_tpu_torch.ops.matching import match_descriptors
    F = desc.shape[0]
    for i in range(F):
        for j in range(F):
            want = match_descriptors(desc[i], valid[i], desc[j], valid[j],
                                     tile=2048)
            for k, w in want._asdict().items():
                got = torch.as_tensor(ap[k][i, j]).to(w.device)
                assert torch.equal(got, w), (i, j, k)


def init_one_rank(tmp) -> None:
    from popsift_tpu_torch.utils.device import init_distributed
    init_distributed(num_processes=1, process_id=0, backend="nccl",
                     init_method=f"file://{tmp}/store")


# ---------------------------------------------------------------------------
# data-parallel extraction, matching, BA and averaging
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp1(card, tmp_path_factory):
    """World size 1 on NCCL: ``make_batched_extract_fn(match_pairs=True)``
    of the four frames (and a second run under sync debug mode "error"),
    ``extract_batch`` of them, all-pairs over their first ``AP_ROWS``
    valid descriptors, distributed BA (each LM loop again under sync
    debug mode "error") and edge-sharded averaging, each with its
    single-process run; the features and ring pairs saved for the ranks
    of world size 2."""
    import torch.distributed as dist

    from popsift_tpu_torch.ops.matching import match_descriptors
    from popsift_tpu_torch.parallel import batch as PB
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.pipeline import build_extract_plan, extract_batch
    from popsift_tpu_torch.sfm import ba as B
    dev, frames = card.dev, card.frames
    cfg = SiftConfig(extrema_capacity=CAPACITY)
    F, (H, W) = len(frames), frames[0].shape
    imgs = torch.from_numpy(np.stack(frames)).to(dev)
    tmp = tmp_path_factory.mktemp("dp1")
    init_one_rank(tmp)
    try:
        mesh = M.make_mesh(device=dev)
        plan = build_extract_plan(cfg, H, W)
        dp_fn = PB.make_batched_extract_fn(cfg, H, W, mesh, match_pairs=True)
        extract_batch(imgs, plan, dev)
        ref, want = launches_of(lambda: extract_batch(imgs, plan, dev))
        dp_fn(imgs)
        (feats, ring), launches = launches_of(lambda: dp_fn(imgs))
        again = without_syncs(lambda: dp_fn(imgs))
        pairs = [match_descriptors(ref.desc[i], ref.desc_valid[i],
                                   ref.desc[(i + 1) % F],
                                   ref.desc_valid[(i + 1) % F], tile=2048)
                 for i in range(F)]
        ap_desc, ap_valid = allpairs_sets(ref, AP_ROWS)
        ap1 = PB.make_allpairs_match_fn(mesh)(ap_desc, ap_valid)
        pd = B.problem_from_numpy(card.fields, dev)
        ref_cost = {
            "dense": float(B.bundle_adjust(pd, iters=10, dense=True)[1][-1]),
            "cg": float(B.bundle_adjust(pd, iters=10, dense=False,
                                        cg_iters=25)[1][-1])}
        ba1 = ba_runs(mesh, card.fields, card.step_fields, dev)
        for kind in ("dense", "cg"):
            without_syncs(ba1[kind].pop("fn"))
        p64 = as_f64(B.problem_from_numpy(card.step_fields, dev))
        lam = p64.cams.new_full((), 1e-3)
        steps = {"dense": B.schur_dense_step(p64, lam)[:2],
                 "cg": B.schur_cg_step(p64, lam, cg_iters=25)[:2]}
        avg_ref = avg_solves(card.graph, dev)
        avg1 = avg_solves(card.graph, dev, mesh)
    finally:
        dist.destroy_process_group()
    saved = os.path.join(tmp, "ref.pt")
    torch.save({"feats": {k: v.cpu() for k, v in feats._asdict().items()},
                "ring": {k: v.cpu() for k, v in ring._asdict().items()}},
               saved)
    return SimpleNamespace(
        ref=ref, feats=feats, ring=ring, again=again, pairs=pairs,
        want=want, launches=launches,
        ap_desc=ap_desc, ap_valid=ap_valid, ap1=ap1, ref_cost=ref_cost,
        ba1=ba1, steps=steps, avg_ref=avg_ref, avg1=avg1, saved=saved)


def test_data_parallel_extraction_world_size_1(dp1):
    """The features bit-equal to ``extract_batch``, 2110 / 2505 on frame 0
    with nothing dropped, the four ring pairs bit-equal to
    ``match_descriptors``, the run under sync debug mode "error" equal;
    its second call launches what ``extract_batch``'s second call does,
    every kernel of the main path, the all-octave ones once, and the
    matcher's kernel once a ring pair."""
    assert dp1.launches == {**dp1.want, "match_top2": len(dp1.pairs)}
    assert all(dp1.launches[k] > 0 for k in MAIN_PATH), dp1.launches
    assert all(dp1.launches[k] == 1 for k in FUSED_ONCE), dp1.launches
    for name, a, b in zip(dp1.feats._fields, dp1.feats, dp1.ref):
        assert torch.equal(a, b), name
    assert (int(dp1.feats.n_keypoints[0]), int(dp1.feats.n_descriptors[0])) \
        == (BENCH_KEYPOINTS, BENCH_DESCRIPTORS)
    assert not dp1.feats.octave_dropped[0].any()
    for i, m in enumerate(dp1.pairs):
        for k, a, b in zip(m._fields, dp1.ring, m):
            assert torch.equal(a[i], b), (i, k)
    for a, b in zip(dp1.again[0], dp1.feats):
        assert torch.equal(a, b)
    for a, b in zip(dp1.again[1], dp1.ring):
        assert torch.equal(a, b)


def test_allpairs_world_size_1(dp1):
    """All 16 pairs of the frames' first 4096 valid descriptors bit-equal
    to ``match_descriptors`` alone."""
    allpairs_equal(dp1.ap1._asdict(), dp1.ap_desc, dp1.ap_valid)


@pytest.mark.parametrize("kind", ["dense", "cg"])
def test_distributed_ba_world_size_1(dp1, kind):
    check_ba(kind, dp1.ba1[kind], dp1.ba1[f"step_{kind}"],
             dp1.ref_cost[kind], dp1.steps[kind])


def test_averaging_world_size_1(dp1):
    check_avg("world size 1", dp1.avg1, dp1.avg_ref)


def parallel_rank(device, frames: np.ndarray, capacity: int, ref_path: str,
                  ap_desc: np.ndarray, ap_valid: np.ndarray, fields: dict,
                  step_fields: dict, graph: tuple) -> dict:
    """One rank of the world-size-2 job: this rank's frames extracted and
    gathered, the ring and all-pairs matches, distributed BA and the
    edge-sharded averaging; the gathered features and ring matches
    compared here with the world-size-1 run saved at ``ref_path``."""
    from popsift_tpu_torch.parallel import batch as PB
    from popsift_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(device=device)
    me, n = M.axis_index(mesh), M.axis_size(mesh)
    b = frames.shape[0] // n
    local = torch.from_numpy(frames[me * b:(me + 1) * b]).to(device)
    ext = PB.make_batched_extract_fn(SiftConfig(extrema_capacity=capacity),
                                     *frames.shape[1:], mesh)
    ext(local)
    (feats, _), launches = launches_of(lambda: ext(local))
    whole = PB.gather_features(feats, mesh)
    ring = PB.gather_features(PB.ring_matches(feats, mesh), mesh)
    ref = torch.load(ref_path)
    gaps = {f"feats.{k}": field_gap(v.cpu(), ref["feats"][k])
            for k, v in whole._asdict().items()}
    gaps.update({f"ring.{k}": field_gap(v.cpu(), ref["ring"][k])
                 for k, v in ring._asdict().items()})
    blk = lambda a: torch.from_numpy(a[me * b:(me + 1) * b]).to(device)
    ap = PB.gather_features(PB.make_allpairs_match_fn(mesh)(
        blk(ap_desc), blk(ap_valid)), mesh)
    ba = ba_runs(mesh, fields, step_fields, device)
    for kind in ("dense", "cg"):
        ba[kind].pop("fn")
    return dict(rank=me, gaps=gaps, ba=ba, launches=launches,
                avg=avg_solves(graph, device, mesh),
                allpairs={k: v.cpu().numpy() for k, v in ap._asdict().items()})


def test_world_size_2_equals_world_size_1(card, dp1):
    """Two processes sharing the card on gloo, two frames each: the
    gathered features and ring pairs (1->2 and 3->0 across the ranks)
    against world size 1 by :func:`check_gaps`, all-pairs equal to world
    size 1, BA and averaging held as at world size 1; each rank's
    all-octave kernels launched once for its frames."""
    from popsift_tpu_torch.parallel.launch import spawn
    torch.cuda.empty_cache()
    ranks = spawn(parallel_rank, 2, "gloo", f"cuda:{card.dev.index or 0}",
                  args=(np.stack(card.frames), CAPACITY, dp1.saved,
                        dp1.ap_desc.cpu().numpy(),
                        dp1.ap_valid.cpu().numpy(), card.fields,
                        card.step_fields, card.graph), timeout=900)
    for r in ranks:
        tag = f"rank {r['rank']}"
        assert all(r["launches"][k] == 1 for k in FUSED_ONCE), \
            (tag, r["launches"])
        check_gaps(tag, r["gaps"])
        for k, v in r["allpairs"].items():
            assert np.array_equal(v, getattr(dp1.ap1, k).cpu().numpy()), \
                (tag, k)
        for kind in ("dense", "cg"):
            check_ba(f"{tag} {kind}", r["ba"][kind], r["ba"][f"step_{kind}"],
                     dp1.ref_cost[kind], dp1.steps[kind])
        check_avg(tag, r["avg"], dp1.avg_ref)


def test_dryrun_two_ranks(card):
    """``tools/dryrun_multichip.py`` at world size 2, both ranks on the
    card (gloo): every item's check holds, and its spatial items (2, 2b)
    equal ``extract``."""
    proc = subprocess.run(
        [sys.executable, "-m", "popsift_tpu_torch.tools.dryrun_multichip",
         "--world-size", "2", "--device", f"cuda:{card.dev.index or 0}",
         "--backend", "gloo"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip:")]
    assert proc.returncode == 0 and lines, \
        f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}"
    assert "spatial pyramid" in lines[-1]
    assert "(equal to extract=True)" in lines[-1]


# ---------------------------------------------------------------------------
# the spatially sharded extraction
# ---------------------------------------------------------------------------

def spatial_fields(feats) -> dict:
    return {k: v.cpu() for k, v in feats._asdict().items()}


def canonical(f: dict) -> dict:
    """One frame's features (CPU tensors) in an order that does not depend
    on how the ranks laid their rows out: the valid keypoints sorted by
    (octave, x, y, sigma) with their orientations, then the valid
    descriptors in that keypoint order (a keypoint's in job order), and
    the counts. A sharded octave's rows are its bands' rows, each band
    front-packed, so two world sizes order them differently."""
    rows = f["valid"].nonzero()[:, 0].numpy()
    key = [f[k].numpy()[rows] for k in ("sigma", "y", "x", "octave")]
    order = rows[np.lexsort(key)]
    rank = np.full(f["valid"].shape[0], -1)
    rank[order] = np.arange(order.size)
    drows = f["desc_valid"].nonzero()[:, 0].numpy()
    dorder = drows[np.lexsort((drows, rank[f["desc_kp"].numpy()[drows]]))]
    out = {k: f[k][torch.from_numpy(order)] for k in
           ("x", "y", "sigma", "octave", "num_ori", "ori", "ori_valid")}
    out["desc"] = f["desc"][torch.from_numpy(dorder)]
    for k in ("n_keypoints", "n_descriptors", "octave_candidates",
              "octave_dropped"):
        out[k] = f[k]
    return out


def gaps_of(got, ref: dict, layout: bool = True) -> dict:
    """Field gaps (:func:`field_gap`) of features ``got`` to the CPU
    fields ``ref``: row for row, or with ``layout=False`` of their
    :func:`canonical` forms."""
    got = spatial_fields(got)
    if not layout:
        got, ref = canonical(got), canonical(ref)
    return {k: field_gap(v, ref[k]) for k, v in got.items()}


def capture_bounded():
    """Wrap the three bounded entries where the ops modules call them;
    returns (captured {K2, K3, K4: (args, kwargs)} of each last bounded
    call, restore)."""
    from popsift_tpu_torch.ops import descriptors, extrema, orientation
    sites = [(extrema, "refine_state_octaves", "K2"),
             (orientation, "orientation_hist_octaves", "K3"),
             (descriptors, "descriptor_loop_octaves", "K4")]
    captured, saved = {}, []
    for mod, name, tag in sites:
        real = getattr(mod, name)
        saved.append((mod, name, real))

        def wrap(*a, _real=real, _tag=tag, **k):
            captured[_tag] = (a, k)
            return _real(*a, **k)
        setattr(mod, name, wrap)

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return captured, restore


def check_bounded_kernels(captured: dict) -> None:
    """The bounded launches of K2, K3 and K4 that one sharded extraction
    made on a band, again, against their plain versions on the same
    tensors (K2 bit-equal, K3 and K4 within 1e-5 x the row's max) and,
    with whole-stack bounds on the same stacks, bit-equal to the
    unbounded launch."""
    from popsift_tpu_torch.ops.kernels import desc, orient, refine
    a, k = captured["K2"]
    assert torch.equal(refine.refine_state_octaves(*a, **k),
                       refine.refine_state_octaves_torch(*a, **k))
    plain = {kk: v for kk, v in k.items() if kk not in ("y_offsets",
                                                         "heights")}
    dflt = dict(plain, y_offsets=[0] * len(a[0]),
                heights=[d.shape[1] for d in a[0]])
    assert torch.equal(refine.refine_state_octaves(*a, **dflt),
                       refine.refine_state_octaves(*a, **plain))
    for tag, fn, fn_torch in (
            ("K3", orient.orientation_hist_octaves,
             orient.orientation_hist_octaves_torch),
            ("K4", desc.descriptor_loop_octaves,
             desc.descriptor_loop_octaves_torch)):
        a, k = captured[tag]
        assert rel_row_err(fn(*a, **k), fn_torch(*a, **k)) <= 1e-5, tag
        plain = {kk: v for kk, v in k.items() if kk not in ("y_offsets",
                                                             "y_bounds")}
        dflt = dict(plain, y_offsets=[0] * len(a[0]),
                    y_bounds=[(1, b.shape[1] - 2) for b in a[0]])
        assert torch.equal(fn(*a, **dflt), fn(*a, **plain)), tag


@pytest.fixture(scope="module")
def sp1(card, tmp_path_factory):
    """World size 1 on NCCL: ``make_sharded_extract_fn`` of frames 0 and 1
    (capacity 8192) and of the 4K frame (``CAPACITY_4K``), each frame's
    fields against ``extract`` at the effective capacities, the counts,
    and at 1080p a second run under sync debug mode "error"; the results
    saved for the ranks of world size 2."""
    import torch.distributed as dist

    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.spatial import make_sharded_extract_fn
    from popsift_tpu_torch.pipeline import build_extract_plan, extract
    dev = card.dev
    tmp = tmp_path_factory.mktemp("sp1")
    out, refs = {}, {}
    init_one_rank(tmp)
    try:
        mesh = M.make_mesh(device=dev, axis_name="sp")
        for tag, imgs, cap in (("1080p", np.stack(card.frames[:2]), CAPACITY),
                               ("4k", card.frame4k[None], CAPACITY_4K)):
            H, W = imgs.shape[1:]
            fn, eff = make_sharded_extract_fn(SiftConfig(
                extrema_capacity=cap), H, W, mesh)
            plan = build_extract_plan(SiftConfig(extrema_capacity=cap), H, W,
                                      octave_caps=eff)
            x = [torch.from_numpy(f).to(dev) for f in imgs]
            fn(x[0])
            feats, launches = launches_of(lambda: fn(x[0]))
            r = dict(gaps=[], eff=list(eff), launches=launches,
                     dropped=feats.octave_dropped.tolist(),
                     counts=(int(feats.n_keypoints),
                             int(feats.n_descriptors)))
            for i, f in enumerate(x):
                got = feats if i == 0 else fn(f)
                want = extract(f, plan, dev)
                r["gaps"].append(gaps_of(got, spatial_fields(want)))
                refs[f"{tag}_{i}"] = spatial_fields(got)
            r["candidates"] = want.octave_candidates.tolist()
            if tag == "1080p":
                again = without_syncs(lambda: fn(x[0]))
                r["again_equal"] = all(torch.equal(a, b)
                                       for a, b in zip(again, feats))
            out[tag] = r
            del fn, plan, x, feats, want, got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(refs, os.path.join(tmp, "ws1.pt"))
    return SimpleNamespace(tmp=str(tmp), **out)


@pytest.mark.parametrize("tag", ["1080p", "4k"])
def test_sharded_world_size_1_equals_extract(sp1, tag):
    """Every field against ``extract`` at the effective capacities by
    :func:`check_gaps`, no octave saturated or dropping; at 1080p 2110 /
    2505 on frame 0 and the run under sync debug mode "error" equal; a
    second call launches every kernel of the sharded path, K1, the
    compaction and the bounded K2-K4 once, the unbounded K2-K4 never."""
    r = getattr(sp1, tag)
    n = r["launches"]
    assert all(n[k] > 0 for k in SPATIAL_PATH), n
    assert all(n[k] == 1 for k in BOUNDED + ("extrema_mask_octaves",
                                             "compact")), n
    assert all(n[k] == 0 for k in ("refine_octaves",
                                   "orientation_hist_octaves",
                                   "descriptor_loop_octaves")), n
    for i, g in enumerate(r["gaps"]):
        check_gaps(f"{tag} frame {i}", g)
    assert all(c < e for c, e in zip(r["candidates"], r["eff"])), r
    assert not any(r["dropped"]), r
    if tag == "1080p":
        assert r["counts"] == (BENCH_KEYPOINTS, BENCH_DESCRIPTORS)
        assert r["again_equal"]


def spatial_rank(device, frames: np.ndarray, frame4k: np.ndarray,
                 capacity: int, capacity_4k: int, tmp: str) -> dict:
    """One rank of a job whose ranks split the rows: frames 0 and 1 and
    the 4K frame through ``make_sharded_extract_fn``, each against world
    size 1's result saved in ``tmp`` (both in :func:`canonical` order);
    rank 0 saves its 1080p results; the last rank holds its band's
    bounded launches to their plain versions."""
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.spatial import make_sharded_extract_fn
    mesh = M.make_mesh(device=device, axis_name="sp")
    me, n = M.axis_index(mesh), M.axis_size(mesh)
    ref = torch.load(os.path.join(tmp, "ws1.pt"))
    out = dict(rank=me)
    for tag, imgs, cap in (("1080p", frames, capacity),
                           ("4k", frame4k[None], capacity_4k)):
        H, W = imgs.shape[1:]
        hs = H // n
        fn, _ = make_sharded_extract_fn(SiftConfig(extrema_capacity=cap), H,
                                        W, mesh)
        bands = [torch.from_numpy(f[me * hs:(me + 1) * hs]).to(device)
                 for f in imgs]
        fn(bands[0])
        first, out[f"launches_{tag}"] = launches_of(lambda: fn(bands[0]))
        got = [first] + [fn(b) for b in bands[1:]]
        out[tag] = [gaps_of(g, ref[f"{tag}_{i}"], layout=False)
                    for i, g in enumerate(got)]
        if me == 0 and tag == "1080p":
            torch.save({f"f{i}": spatial_fields(g) for i, g in
                        enumerate(got)}, os.path.join(tmp, "ws2.pt"))
        del got
        if tag == "1080p":
            # every rank runs the call (its collectives need them all)
            captured, restore = capture_bounded()
            try:
                fn(bands[0])
            finally:
                restore()
            if me == n - 1:
                check_bounded_kernels(captured)
                out["bounded_checked"] = True
            del captured
        del fn, bands
        torch.cuda.empty_cache()
    M.psum(torch.zeros(1, device=device), mesh)   # every rank done
    return out


@pytest.fixture(scope="module")
def sp2(card, sp1):
    from popsift_tpu_torch.parallel.launch import spawn
    return spawn(spatial_rank, 2, "gloo", f"cuda:{card.dev.index or 0}",
                 args=(np.stack(card.frames[:2]), card.frame4k, CAPACITY,
                       CAPACITY_4K, sp1.tmp), timeout=900)


def test_sharded_world_size_2_equals_world_size_1(sp2):
    """Two ranks sharing the card on gloo, each a band of rows: frames 0-1
    and the 4K frame against world size 1 by :func:`check_gaps`; the last
    rank's bounded K2, K3 and K4 against their plain versions; each
    rank's K1, compaction and bounded K2-K4 launched once a frame."""
    for r in sp2:
        for tag in ("1080p", "4k"):
            n = r[f"launches_{tag}"]
            assert all(n[k] == 1 for k in BOUNDED + ("extrema_mask_octaves",
                                                     "compact")), (tag, n)
            for i, g in enumerate(r[tag]):
                check_gaps(f"rank {r['rank']} {tag} frame {i}", g)
    assert sp2[-1].get("bounded_checked")


def spatial_dpsp_rank(device, frames: np.ndarray, capacity: int,
                      tmp: str) -> dict:
    """One rank of a (2, 2) mesh: the two frames, one a "dp" group, each
    row-sharded over its "sp" pair (``make_batched_sharded_extract_fn``),
    gathered over "dp"; the gaps to the world-size-2 results in ``tmp``
    (the same row layout)."""
    from popsift_tpu_torch.parallel import mesh as M
    from popsift_tpu_torch.parallel.batch import gather_features
    from popsift_tpu_torch.parallel.spatial import (
        make_batched_sharded_extract_fn)
    m2 = M.make_mesh_2d(2, 2, names=("dp", "sp"), device=device)
    i, j = m2.coords["dp"], m2.coords["sp"]
    H, W = frames.shape[1:]
    fn, _ = make_batched_sharded_extract_fn(SiftConfig(
        extrema_capacity=capacity), H, W, m2)
    band = torch.from_numpy(frames[i:i + 1, j * H // 2:(j + 1) * H // 2]
                            ).to(device)
    fn(band)
    feats, launches = launches_of(lambda: fn(band))
    whole = gather_features(feats, m2, "dp")
    ref = torch.load(os.path.join(tmp, "ws2.pt"))
    gaps = [{k: field_gap(v[f].cpu(), ref[f"f{f}"][k])
             for k, v in whole._asdict().items()} for f in range(2)]
    return dict(coords=(i, j), gaps=gaps, launches=launches)


def test_dp_by_sp_equals_world_size_2(card, sp1, sp2):
    """DP x SP, a (2, 2) mesh of four ranks on the card: frames 0-1
    against their world-size-2 results by :func:`check_gaps`; each
    rank's bounded K2-K4 launched once."""
    from popsift_tpu_torch.parallel.launch import spawn
    share = f"cuda:{card.dev.index or 0}"
    quads = spawn(spatial_dpsp_rank, 4, "gloo", share,
                  args=(np.stack(card.frames[:2]), CAPACITY, sp1.tmp),
                  timeout=600)
    for q in quads:
        assert all(q["launches"][k] == 1 for k in BOUNDED), q
        for f, g in enumerate(q["gaps"]):
            check_gaps(f"rank at {q['coords']} frame {f}", g)
