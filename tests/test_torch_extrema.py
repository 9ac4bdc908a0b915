"""popsift_tpu_torch detection against the JAX package on the CPU.

* the candidate mask equals JAX ``_candidate_mask(use_pallas=False)``
  exactly (the wrapper runs the plain version of kernel K1 on the CPU);
* ``_compact_mask`` equals the JAX compaction entry for entry, padding
  entries included, in the small-mask branch, the large-mask branch and
  with the density clamp forced to drop;
* the refinement state (plain version of K2) through
  ``finalize_refined`` matches JAX ``refine_candidates`` and the fused
  Pallas kernel in interpret mode. Tolerances of
  tests/test_pallas_refine.py:41-52: masks and counts exact, floats at
  rtol 1e-6 / atol 2e-5 (XLA may contract a*b+c into an FMA where the
  port rounds twice), at most 2 flips in level/cell.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import extrema as jext
from popsift_tpu.ops.pyramid import assemble_dog_canvas
from popsift_tpu_torch.ops import extrema as text
from test_torch_pipeline import port_config

torch.set_num_threads(1)


def _random_dog(H, W, D=5, seed=0, scale=60.0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(D, H, W)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (1, 2):
        base = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, base)
    return (base * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["popsift", "vlfeat", "opencv"])
def test_candidate_mask_exact(mode):
    cfg = SiftConfig(sift_mode=mode)
    dog = _random_dog(61, 77, seed=5)
    want = np.asarray(jext._candidate_mask(jnp.asarray(dog), cfg,
                                           use_pallas=False))
    got = text._candidate_mask(torch.from_numpy(dog),
                               port_config(cfg)).numpy()
    assert got.shape == want.shape and got.dtype == np.bool_
    assert want.sum() > 10
    assert np.array_equal(got, want)


def _sparse_mask(n, density, seed, clusters=0):
    rng = np.random.default_rng(seed)
    m = rng.random(n) < density
    for c in rng.integers(0, n - 64, size=clusters):
        m[c:c + 40] = True          # dense runs inside one 128-block
    return m


@pytest.mark.parametrize("case", [
    # (mask length, density, capacity, block_k, clusters)
    ("small", 5 * 60 * 80, 0.01, 256, 0, 0),
    ("small_truncated", 5 * 60 * 80, 0.02, 128, 0, 0),
    ("large", 128 * 600, 0.003, 64, 0, 0),
    ("large_truncated", 128 * 600, 0.02, 64, 0, 0),
    ("forced_drop", 5 * 60 * 80, 0.01, 512, 2, 6),
    ("large_forced_drop", 128 * 600, 0.002, 96, 3, 5),
], ids=lambda c: c[0])
def test_compact_mask_exact(case):
    _, n, density, capacity, block_k, clusters = case
    m = _sparse_mask(n, density, seed=n % 97 + capacity, clusters=clusters)
    ji, jn, jd = jext._compact_mask(jnp.asarray(m), capacity,
                                    block_k=block_k)
    ti, tn, td = text._compact_mask(torch.from_numpy(m), capacity,
                                    block_k=block_k)
    assert int(tn) == int(jn)
    assert int(td) == int(jd)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    if block_k:
        assert int(td) > 0          # the clamp really dropped candidates
    # live entries are the ascending set positions
    assert np.all(np.diff(ti.numpy()[:int(tn)]) > 0)
    assert m[ti.numpy()[:int(tn)]].all()


def _assert_extrema_close(got, ref):
    valid = got.valid.numpy()
    assert np.array_equal(valid, np.asarray(ref.valid))
    assert int(got.count) == int(ref.count)
    for f in ("x", "y", "s", "sigma"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=2e-5, err_msg=f)
    for f in ("level", "cell"):
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert int(np.sum(a != b)) <= 2, f


def _port_refined(dog, cfg, cap):
    H, W = dog.shape[1:]
    cfg = port_config(cfg)
    t = torch.from_numpy(dog)
    cand = text.collect_candidates(t, cfg, cap)
    state = text.refine_candidates(t, cand, cfg)
    return cand, text.finalize_refined(state, cand.valid, cfg, W, H,
                                       cand.n_found, cand.n_dropped)


@pytest.mark.parametrize("mode", ["popsift", "vlfeat"])
def test_refine_matches_jax_xla(mode):
    H, W, cap = 67, 93, 256
    cfg = SiftConfig(sift_mode=mode)
    dog = _random_dog(H, W, seed=3)
    jc = jext.collect_candidates(jnp.asarray(dog), cfg, cap)
    ref = jext.refine_candidates(jc, cfg, W, H)
    cand, got = _port_refined(dog, cfg, cap)
    assert int(cand.n_found) == int(jc.n_found) > 0
    assert int(cand.n_dropped) == int(jc.n_dropped) == 0
    for f in ("x0", "y0", "z0"):
        n = int(cand.n_found)
        assert np.array_equal(getattr(cand, f).numpy()[:n],
                              np.asarray(getattr(jc, f))[:n]), f
    assert int(got.count) > 0
    _assert_extrema_close(got, ref)


@pytest.mark.parametrize("mode", ["popsift", "vlfeat"])
def test_refine_matches_pallas_interpret(mode):
    H, W, cap = 67, 93, 256
    cfg = SiftConfig(sift_mode=mode)
    dog = _random_dog(H, W, seed=11)
    canvas = assemble_dog_canvas([jnp.asarray(d) for d in dog], H, W)
    rset = jext.collect_refined(cfg, cap, canvas, (H, W), interpret=True)
    ref = jext.finalize_refined(rset.vals, rset.valid, cfg, W, H,
                                rset.n_found, rset.n_dropped)
    cand, got = _port_refined(dog, cfg, cap)
    assert int(cand.n_found) == int(rset.n_found)
    assert int(got.count) > 0
    _assert_extrema_close(got, ref)


def test_refine_rows_past_count_are_zero():
    cfg = port_config(SiftConfig())
    dog = _random_dog(40, 48, seed=2)
    t = torch.from_numpy(dog)
    cand = text.collect_candidates(t, cfg, 512)
    n = int(cand.n_found)
    state = text.refine_candidates(t, cand, cfg)
    assert 0 < n < 512
    assert state.shape == (512, 16)
    assert torch.all(state[n:] == 0)
    assert torch.all(state[:n, 13:] == 0)
