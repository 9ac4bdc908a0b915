"""The port's frame-batched path against the JAX package on the CPU.

* batched mask (plain version of K1's batched entry) against JAX
  ``candidate_mask_canvas_batched(..., interpret=True)`` on two frames'
  DoG canvases, and the dense mask against JAX
  ``candidate_mask_pallas(..., interpret=True)``: exact;
* batched refinement (plain version of K2's batched entry) through
  ``finalize_refined`` against JAX ``collect_refined_batched(...,
  interpret=True)``, in the pattern and with the tolerances of
  tests/test_pallas_refine.py:41-96 (masks and counts exact, floats
  rtol 1e-6 / atol 2e-5, at most 2 level/cell flips), and candidates on
  a frame's top DoG layer, whose z reads must stay in their own frame;
* ``PopSift.enqueue_batch`` end to end: each frame equals the port's own
  ``enqueue`` exactly, and JAX ``enqueue_batch`` within the golden
  tolerances (tests/test_golden.py:21-24) with exact counts;
* ``calibrate_plan`` capacities equal JAX's, and ``PopSift.calibrate``
  pins the plan that later ``enqueue`` calls use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu import pipeline as jpipe
from popsift_tpu.api import PopSift as JaxPopSift
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops.pallas.extrema_mask import (
    candidate_mask_canvas_batched, candidate_mask_pallas)
from popsift_tpu.ops.pallas.refine import refine_windows_pallas_batched
from popsift_tpu.ops.pyramid import DOG_OX, DOG_OY, assemble_dog_canvas
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch import pipeline as tpipe
from popsift_tpu_torch.ops import extrema as text
from popsift_tpu_torch.ops.kernels import extrema_mask as K1
from popsift_tpu_torch.ops.kernels import refine as K2
from test_golden import _flatten_host
from test_torch_pipeline import (_assert_within_golden_tolerances,
                                 port_config)

torch.set_num_threads(1)


def _random_dog(H, W, D=5, seed=0, scale=60.0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(D, H, W)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (1, 2):
        base = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, base)
    return (base * scale).astype(np.float32)


def _canvas(dog, H, W):
    return assemble_dog_canvas([jnp.asarray(d) for d in dog], H, W)


def _assert_extrema_equal(got, ref):
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.count) == int(ref.count)
    for f in ("x", "y", "s", "sigma"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=2e-5, err_msg=f)
    for f in ("level", "cell"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert int(np.sum(a != b)) <= 2, f


@pytest.mark.parametrize("mode", ["popsift", "opencv"])
def test_batched_mask_matches_pallas_interpret(mode):
    H, W, F = 64, 96, 2
    cfg = SiftConfig(sift_mode=mode)
    dogs = [_random_dog(H, W, seed=s) for s in (1, 4)]
    thr1 = float(np.float32(text._first_threshold(port_config(cfg))))
    canv = jnp.concatenate([_canvas(d, H, W) for d in dogs], axis=0)
    want = np.asarray(candidate_mask_canvas_batched(canv, F, H, W, thr1,
                                                    interpret=True))
    got = K1.candidate_mask_batched(torch.from_numpy(np.concatenate(dogs)),
                                    F, thr1)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert want.sum() > 10
    assert np.array_equal(got.numpy().astype(bool), want)


def test_dense_mask_matches_pallas_interpret():
    dog = _random_dog(61, 77, seed=5)
    thr1 = float(np.float32(text._first_threshold(port_config(SiftConfig()))))
    want = np.asarray(candidate_mask_pallas(jnp.asarray(dog), thr1,
                                            interpret=True))
    got = K1.candidate_mask(torch.from_numpy(dog), thr1)
    assert want.sum() > 10
    assert np.array_equal(got.numpy().astype(bool), want)


@pytest.mark.parametrize("mode", ["popsift", "vlfeat"])
def test_batched_refine_matches_pallas_interpret(mode):
    H, W, F, cap = 64, 96, 2, 256
    cfg = SiftConfig(sift_mode=mode)
    dogs = [_random_dog(H, W, seed=s) for s in (1, 4)]
    canv = jnp.concatenate([_canvas(d, H, W) for d in dogs], axis=0)
    rset = jext.collect_refined_batched(canv, F, cfg, cap, (H, W),
                                        interpret=True)
    got = text.collect_refined_batched(
        torch.from_numpy(np.concatenate(dogs)), F, port_config(cfg), cap)
    assert got.vals.shape == (F * cap, 16)
    assert np.array_equal(got.n_found.numpy(), np.asarray(rset.n_found))
    assert np.array_equal(got.n_dropped.numpy(), np.asarray(rset.n_dropped))
    assert np.array_equal(got.valid.numpy(), np.asarray(rset.valid))
    jvals = rset.vals.reshape(F, cap, -1)
    for f in range(F):
        ref = jext.finalize_refined(jvals[f], rset.valid[f], cfg, W, H,
                                    rset.n_found[f], rset.n_dropped[f])
        mine = text.finalize_refined(got.vals[f * cap:(f + 1) * cap],
                                     got.valid[f], port_config(cfg), W, H,
                                     got.n_found[f], got.n_dropped[f])
        assert int(mine.count) > 0
        _assert_extrema_equal(mine, ref)
        # each frame equals the single-frame collection and refinement
        one = text.collect_candidates(torch.from_numpy(dogs[f]),
                                      port_config(cfg), cap)
        state = text.refine_candidates(torch.from_numpy(dogs[f]), one,
                                       port_config(cfg))
        assert int(one.n_found) == int(got.n_found[f])
        assert torch.equal(state, got.vals[f * cap:(f + 1) * cap])


@pytest.mark.parametrize("vlfeat", [False, True])
def test_batched_refine_top_layer_stays_in_frame(vlfeat):
    """Candidates on a frame's top DoG layer (z = D-1): the z+1 read
    clamps to that frame's own top layer, as the JAX kernel's per-job
    layer base does, not to the next frame's layer 0."""
    H, W, F, D, cap = 40, 56, 2, 5, 16
    dogs = np.concatenate([_random_dog(H, W, seed=s) for s in (2, 9)])
    rng = np.random.default_rng(3)
    x0 = rng.integers(8, W - 8, F * cap)
    y0 = rng.integers(8, H - 8, F * cap)
    z0 = rng.integers(1, D, F * cap)
    z0[::2] = D - 1
    n_found = np.array([cap, 11])
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = K2.refine_state_batched(t(dogs), t(x0), t(y0), t(z0), t(n_found),
                                  F, maxlevel=D, vlfeat=vlfeat)
    canv = jnp.concatenate([_canvas(dogs[f * D:(f + 1) * D], H, W)
                            for f in range(F)], axis=0)
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))
    want = np.asarray(refine_windows_pallas_batched(
        canv, i32(np.repeat(np.arange(F) * D, cap)), i32(y0), i32(x0),
        i32(z0), None, oy=DOG_OY, ox=DOG_OX, D=D, W=W, H=H, maxlevel=D,
        vlfeat=vlfeat, interpret=True))
    for f in range(F):
        rows = slice(f * cap, f * cap + int(n_found[f]))
        np.testing.assert_array_equal(got[rows, :3].numpy(), want[rows, :3])
        np.testing.assert_allclose(got[rows].numpy(), want[rows],
                                   rtol=1e-6, atol=2e-5)
        assert torch.all(got[f * cap + int(n_found[f]):(f + 1) * cap] == 0)
        one = K2.refine_state_torch(t(dogs[f * D:(f + 1) * D]),
                                    t(x0[f * cap:(f + 1) * cap]),
                                    t(y0[f * cap:(f + 1) * cap]),
                                    t(z0[f * cap:(f + 1) * cap]),
                                    int(n_found[f]), maxlevel=D,
                                    vlfeat=vlfeat)
        assert torch.equal(got[f * cap:(f + 1) * cap], one)
    # without the per-frame clamp frame 0's top-layer rows would differ
    whole = K2.refine_state_torch(t(dogs), t(x0[:cap]), t(y0[:cap]),
                                  t(z0[:cap]), cap, maxlevel=D,
                                  vlfeat=vlfeat)
    assert not torch.equal(whole, got[:cap])


SEEDS = (7, 8, 9)


@pytest.fixture(scope="module")
def batch_runs():
    cfg = SiftConfig(octaves=4)
    frames = [synthetic_image(120, 160, seed=s) for s in SEEDS]
    ps = tapi.PopSift(port_config(cfg), device="cpu")
    jobs = ps.enqueue_batch(frames)
    single = [ps.enqueue(f) for f in frames]
    jax_hosts = [j.get() for j in JaxPopSift(cfg).enqueue_batch(frames)]
    return jobs, single, jax_hosts


@pytest.mark.parametrize("f", range(len(SEEDS)))
def test_enqueue_batch_equals_enqueue(batch_runs, f):
    jobs, single, _ = batch_runs
    for a, b, name in zip(jobs[f].raw, single[f].raw,
                          jobs[f].raw._fields):
        assert a.shape == b.shape and torch.equal(a, b), name
    got, want = jobs[f].get(), single[f].get()
    assert got.getFeatureCount() == want.getFeatureCount() > 0
    assert got.getDescriptorCount() == want.getDescriptorCount()
    for k in ("x", "y", "sigma", "octave", "num_ori", "orientations",
              "ori_valid", "descriptors", "desc_to_kp"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("f", range(len(SEEDS)))
def test_enqueue_batch_matches_jax(batch_runs, f):
    jobs, _, jax_hosts = batch_runs
    got, want = jobs[f].get(), jax_hosts[f]
    assert got.getFeatureCount() == want.getFeatureCount() > 0
    assert got.getDescriptorCount() == want.getDescriptorCount()
    _assert_within_golden_tolerances(_flatten_host(got), _flatten_host(want))


def test_calibrate_plan_matches_jax():
    cfg = SiftConfig(octaves=3)
    frames = [synthetic_image(64, 80, seed=s) for s in (3, 5)]
    want = jpipe.calibrate_plan(cfg, frames, headroom=1.25)
    got = tpipe.calibrate_plan(port_config(cfg), frames, headroom=1.25,
                               device="cpu")
    assert got.ext_caps == want.ext_caps
    assert got.job_caps == want.job_caps
    probe = tpipe.make_probe_fn(
        tpipe.build_extract_plan(
            port_config(cfg.replace(extrema_capacity=8192)), 64, 80),
        "cpu")
    counts = np.maximum(probe(frames[0]), probe(frames[1]))
    assert counts.sum() > 0
    assert all(c * 1.25 < cap for c, cap in zip(counts, got.ext_caps))


def test_popsift_calibrate_pins_the_plan():
    cfg = SiftConfig(octaves=3)
    frame = synthetic_image(64, 80, seed=3)
    ps = tapi.PopSift(port_config(cfg), device="cpu")
    plan = ps.calibrate([frame])
    assert plan.ext_caps != tpipe.build_extract_plan(port_config(cfg), 64,
                                                     80).ext_caps
    job = ps.enqueue(frame)
    assert job.raw.x.shape == (sum(plan.ext_caps),)
    assert job.raw.desc.shape == (sum(plan.job_caps), 128)
    host = job.get()
    want = tapi.PopSift(port_config(cfg), device="cpu").enqueue(frame).get()
    assert host.getFeatureCount() == want.getFeatureCount() > 0
    assert np.array_equal(host.descriptors, want.descriptors)
    batch = ps.enqueue_batch([frame, frame])
    assert batch[1].raw.x.shape == (sum(plan.ext_caps),)
