"""The patch-window detection route of the port against the JAX package.

The window copy (kernel K6's plain version on the CPU) against
``extract_windows_pallas`` / ``extract_windows_pallas_batched`` in
interpret mode and against the vmapped ``dynamic_slice`` twin, exact;
``refine_patches`` against JAX ``refine_candidates`` on the same merged
CandidateSet (masks and counts exact, floats within the tolerance of
tests/test_torch_extrema.py); and the route end to end: ``detect=
"windows"`` against JAX ``extract`` on the CPU (which is this route) on
the two default golden scenes within the golden tolerances, against the
port's own ``detect="fused"``, and batched against single frames.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops.pallas.window import (extract_windows_pallas,
                                           extract_windows_pallas_batched)
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch import pipeline as tpipe
from popsift_tpu_torch.ops import extrema as text
from popsift_tpu_torch.ops.kernels import window as K6
from test_golden import GOLDEN_DIR, _flatten_host, _load_cases
from test_torch_extrema import _assert_extrema_close, _random_dog
from test_torch_pipeline import (CASES, _assert_within_golden_tolerances,
                                 port_config)

torch.set_num_threads(1)
R, P = 5, 11


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _i32(a):
    return jnp.asarray(np.asarray(a, np.int32))


def _padded(vol, W):
    """The volume as popsift_tpu/ops/extrema.py:377-379 pads it for the
    window kernel: edge-replicated, R on the top and left."""
    Wpad = -(-(W + R + 256) // 128) * 128
    return jnp.pad(jnp.asarray(vol), ((0, 0), (R, R + 16),
                                      (R, Wpad - W - R)), mode="edge")


def _centres(rng, K, H, W):
    """K centres, the first ones on the image border and corners."""
    cy = rng.integers(0, H, K)
    cx = rng.integers(0, W, K)
    cy[:4] = [0, H - 1, 0, H - 1]
    cx[:4] = [0, W - 1, W - 1, 0]
    cy[4], cx[5] = 2, W - 3
    return cy, cx


@pytest.mark.parametrize("n_valid", [16, 13, 8, 0])
def test_windows_match_pallas_interpret(n_valid):
    D, H, W, K = 5, 64, 96, 16
    rng = np.random.default_rng(11)
    vol = rng.normal(size=(D, H, W)).astype(np.float32)
    cy, cx = _centres(rng, K, H, W)
    want, _, _ = extract_windows_pallas(
        _padded(vol, W), _i32(cy + R), _i32(cx + R), R, P, P,
        n_valid=jnp.int32(n_valid), interpret=True)
    want = np.asarray(want)
    got = K6.extract_windows(_t(vol), _t(cy), _t(cx), torch.tensor(n_valid),
                             R, P, P)
    assert got.shape == (K, D, P, P) and got.dtype == torch.float32
    # exact on the live rows; the port zeroes every row past the count
    # (the TPU kernel zeroes whole blocks of 8 past it)
    assert np.array_equal(got.numpy()[:n_valid], want[:n_valid])
    assert torch.all(got[n_valid:] == 0)
    blk = -(-n_valid // 8) * 8
    assert np.all(want[blk:] == 0)


def test_windows_general_shape_matches_numpy():
    """rows x cols other than 11 x 11 (the entry takes them), clamped."""
    D, H, W, K = 3, 20, 150, 9
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(D, H, W)).astype(np.float32)
    cy, cx = _centres(rng, K, H, W)
    got = K6.extract_windows(_t(vol), _t(cy), _t(cx), torch.tensor(K), 3,
                             16, 128).numpy()
    for k in range(K):
        yy = np.clip(cy[k] - 3 + np.arange(16), 0, H - 1)
        xx = np.clip(cx[k] - 3 + np.arange(128), 0, W - 1)
        assert np.array_equal(got[k], vol[:, yy[:, None], xx[None, :]])
    with pytest.raises(ValueError, match="at most 16 x 128"):
        K6.extract_windows(_t(vol), _t(cy), _t(cx), torch.tensor(K), 3, 17, 8)


@pytest.mark.parametrize("mode", ["popsift", "opencv"])
def test_collected_windows_match_dynamic_slice_twin(mode):
    """collect_candidates(windows=True) against the JAX collection on the
    CPU, whose windows are the vmapped dynamic_slice of the padded DoG."""
    H, W, cap = 67, 93, 256
    cfg = SiftConfig(sift_mode=mode)
    dog = _random_dog(H, W, seed=3)
    jc = jext.collect_candidates(jnp.asarray(dog), cfg, cap)
    tc = text.collect_candidates(_t(dog), port_config(cfg), cap,
                                 windows=True)
    n = int(jc.n_found)
    assert int(tc.n_found) == n > 10
    assert tc.patches.shape == (cap, 5, P, P)
    assert np.array_equal(tc.patches.numpy()[:n], np.asarray(jc.patches)[:n])
    assert torch.all(tc.patches[n:] == 0)
    for f in ("x0", "y0", "z0"):
        assert np.array_equal(getattr(tc, f).numpy()[:n],
                              np.asarray(getattr(jc, f))[:n]), f
    assert text.collect_candidates(_t(dog), port_config(cfg),
                                   cap).patches is None


def test_batched_windows_stay_in_their_frame():
    """Frame f's windows read layers [f*D, f*D + D) only, with candidates
    on the image border and on a frame's top DoG layer; against the JAX
    batched kernel with its per-job layer base, and against each frame's
    own single-frame copy."""
    D, H, W, F, cap = 5, 40, 56, 2, 16
    rng = np.random.default_rng(5)
    vol = np.concatenate([_random_dog(H, W, seed=s) for s in (2, 9)])
    cy, cx = _centres(rng, F * cap, H, W)
    cy[cap:cap + 4], cx[cap:cap + 4] = cy[:4], cx[:4]
    n_found = np.array([cap, 11])
    got = K6.extract_windows_batched(_t(vol), _t(cy), _t(cx), _t(n_found),
                                     F, R, P, P)
    assert got.shape == (F * cap, D, P, P)
    ba = (np.arange(cap // 8)[None, :] * 8 < n_found[:, None]).reshape(-1)
    want = np.asarray(extract_windows_pallas_batched(
        _padded(vol, W), _i32(np.repeat(np.arange(F) * D, cap)),
        _i32(cy + R), _i32(cx + R), R, P, P, D, block_valid=_i32(ba),
        interpret=True))
    for f in range(F):
        n = int(n_found[f])
        rows = slice(f * cap, f * cap + n)
        assert np.array_equal(got[rows].numpy(), want[rows])
        assert torch.all(got[f * cap + n:(f + 1) * cap] == 0)
        one = K6.extract_windows(
            _t(vol[f * D:(f + 1) * D]), _t(cy[f * cap:(f + 1) * cap]),
            _t(cx[f * cap:(f + 1) * cap]), torch.tensor(n), R, P, P)
        assert torch.equal(got[f * cap:(f + 1) * cap], one)
    # the top layer of frame 0's windows is frame 0's own top layer
    assert torch.equal(got[0, D - 1, R, R],
                       _t(vol)[D - 1, int(cy[0]), int(cx[0])])


def test_batched_collection_matches_single_frames():
    H, W, F, cap = 64, 96, 2, 256
    cfg = port_config(SiftConfig())
    dogs = [_random_dog(H, W, seed=s) for s in (1, 4)]
    got = text.collect_candidates_batched(_t(np.concatenate(dogs)), F, cfg,
                                          cap, windows=True)
    assert got.patches.shape == (F * cap, 5, P, P)
    for f in range(F):
        one = text.collect_candidates(_t(dogs[f]), cfg, cap, windows=True)
        assert int(one.n_found) == int(got.n_found[f]) > 10
        assert torch.equal(got.patches[f * cap:(f + 1) * cap], one.patches)


@pytest.mark.parametrize("mode", ["popsift", "vlfeat"])
def test_refine_patches_matches_jax_on_merged_octaves(mode):
    """One refinement over two octaves' merged windows with per-row
    dims, as popsift_tpu/pipeline.py:268-276 runs it."""
    cfg = SiftConfig(sift_mode=mode)
    tcfg = port_config(cfg)
    shapes, cap = ((67, 93), (34, 47)), 128
    dogs = [_random_dog(h, w, seed=3 + i) for i, (h, w) in enumerate(shapes)]
    jcs = [jext.collect_candidates(jnp.asarray(d), cfg, cap) for d in dogs]
    cat = lambda f: jnp.concatenate([getattr(c, f) for c in jcs])
    w_row = np.concatenate([np.full(cap, w, np.int32) for _, w in shapes])
    h_row = np.concatenate([np.full(cap, h, np.int32) for h, _ in shapes])
    merged = jext.CandidateSet(
        patches=cat("patches"), x0=cat("x0"), y0=cat("y0"), z0=cat("z0"),
        valid=cat("valid"),
        n_found=jnp.stack([c.n_found for c in jcs]).sum(),
        n_dropped=jnp.stack([c.n_dropped for c in jcs]).sum())
    ref = jext.refine_candidates(merged, cfg, w_row, h_row)

    tcs = [text.collect_candidates(_t(d), tcfg, cap, windows=True)
           for d in dogs]
    tcat = lambda f: torch.cat([getattr(c, f) for c in tcs])
    state = text.refine_patches(tcat("patches"), tcat("x0"), tcat("y0"),
                                tcat("z0"), tcat("valid"), tcfg, _t(w_row),
                                _t(h_row))
    assert state.shape == (2 * cap, 16)
    got = text.finalize_refined(state, tcat("valid"), tcfg, _t(w_row),
                                _t(h_row), 0, 0)
    assert int(got.count) > 10
    assert all(int(c.n_found) > 10 for c in tcs)
    _assert_extrema_close(got, ref)
    # the same state as the fused route's, row for row
    fused = torch.cat([text.refine_candidates(_t(d), c, tcfg)
                       for d, c in zip(dogs, tcs)])
    assert torch.equal(state, fused)


@pytest.fixture(scope="module")
def route_runs():
    """Both golden scenes through the port's two detection routes and
    through JAX (on the CPU its extract is the window route)."""
    from popsift_tpu.api import PopSift as JaxPopSift
    out = {}
    for name in CASES:
        img, cfg, _ = _load_cases()[name]
        tcfg = port_config(cfg)
        out[name] = (
            tapi.PopSift(tcfg, device="cpu", detect="windows").enqueue(img),
            tapi.PopSift(tcfg, device="cpu").enqueue(img),
            JaxPopSift(cfg).enqueue(img).get())
    return out


@pytest.mark.parametrize("name", CASES)
def test_window_route_matches_jax(route_runs, name):
    win, _, ref = route_runs[name]
    got = win.get()
    assert got.getFeatureCount() == ref.getFeatureCount() > 0
    assert got.getDescriptorCount() == ref.getDescriptorCount()
    _assert_within_golden_tolerances(_flatten_host(got), _flatten_host(ref))


@pytest.mark.parametrize("name", CASES)
def test_window_route_within_golden(route_runs, name):
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    _assert_within_golden_tolerances(
        _flatten_host(route_runs[name][0].get()), want)


@pytest.mark.parametrize("name", CASES)
def test_window_route_equals_fused_route(route_runs, name):
    """Same keypoint set; float fields equal or within 1e-6 x magnitude."""
    win, fused, _ = route_runs[name]
    for f, a, b in zip(win.raw._fields, win.raw, fused.raw):
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), f
        else:
            assert torch.equal(a, b), f


def test_batched_window_route_equals_single_frames():
    cfg = port_config(SiftConfig(octaves=3))
    frames = [synthetic_image(64, 80, seed=s) for s in (3, 5)]
    plan = tpipe.build_extract_plan(cfg, 64, 80)
    out = tpipe.extract_batch(np.stack(frames), plan, "cpu",
                              detect="windows")
    for f, frame in enumerate(frames):
        one = tpipe.extract(frame, plan, "cpu", detect="windows")
        assert int(one.n_keypoints) > 0
        for name, a, b in zip(one._fields, tpipe.frame_features(out, f), one):
            assert a.shape == b.shape and torch.equal(a, b), name


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="detect"):
        tapi.PopSift(device="cpu", detect="unfused")
    plan = tpipe.build_extract_plan(port_config(SiftConfig(octaves=2)), 32, 40)
    with pytest.raises(ValueError, match="detect"):
        tpipe.extract(np.zeros((32, 40), np.uint8), plan, "cpu",
                      detect="patches")
