"""popsift_tpu_torch.ops.gridfilter against the JAX package on the CPU.

Keep-masks must equal JAX's exactly, for ``largest``, ``smallest`` and
``random``: planted ties in sigma (the stable sort decides among them),
under- and over-budget frames, invalid rows, and a batch of frames
filtered at once, each frame as JAX filters it alone. The cases of
tests/test_variants.py that hold the filter to the reference's host
algorithm run on the port too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops import gridfilter as jgf
from popsift_tpu_torch.config import SiftConfig as PortSiftConfig
from popsift_tpu_torch.ops import gridfilter as tgf
from test_variants import _ref_gridfilter_numpy

MODES = ("largest", "smallest", "random")


def _port(cfg):
    return PortSiftConfig(**dataclasses.asdict(cfg))


def _frame(rng, n, n_cells, ties=True, p_valid=0.7):
    """Cells, sigmas (from four values when ``ties``: many exact ties)
    and validity of one frame; invalid rows carry cell 0 and sigma 0, as
    the accept test leaves them."""
    cell = rng.integers(0, n_cells, n).astype(np.int32)
    if ties:
        sigma = rng.choice(np.float32([1.6, 2.0159, 2.54, 3.2]), n)
    else:
        sigma = rng.uniform(1.0, 8.0, n).astype(np.float32)
    valid = rng.random(n) < p_valid
    return (np.where(valid, cell, 0).astype(np.int32),
            np.where(valid, sigma, 0).astype(np.float32), valid)


def _jax_keep(cell, sigma, valid, cfg, maybe=True):
    fn = jgf.maybe_grid_filter if maybe else jgf.grid_filter_mask
    return np.asarray(fn(jnp.asarray(cell), jnp.asarray(sigma),
                         jnp.asarray(valid), cfg))


def _port_keep(cell, sigma, valid, cfg, maybe=True):
    fn = tgf.maybe_grid_filter if maybe else tgf.grid_filter_mask
    return fn(torch.from_numpy(cell.astype(np.int64)),
              torch.from_numpy(sigma), torch.from_numpy(valid),
              _port(cfg)).numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("budget,grid,ties", [(20, 2, True), (100, 2, True),
                                              (100, 3, False), (40, 4, True),
                                              (1000, 2, True)],
                         ids=["tight", "loose", "grid3", "grid4",
                              "under_budget"])
def test_keep_mask_equals_jax(mode, budget, grid, ties):
    rng = np.random.default_rng(budget + grid)
    cell, sigma, valid = _frame(rng, 600, grid * grid, ties)
    cfg = SiftConfig(filter_max_extrema=budget, filter_grid_size=grid,
                     grid_filter_mode=mode)
    want = _jax_keep(cell, sigma, valid, cfg)
    got = _port_keep(cell, sigma, valid, cfg)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert not (got & ~valid).any()
    if budget >= valid.sum():
        assert np.array_equal(got, valid)       # under budget: all kept
    else:
        assert got.sum() < valid.sum()
    # the unconditional mask too
    assert np.array_equal(_port_keep(cell, sigma, valid, cfg, maybe=False),
                          _jax_keep(cell, sigma, valid, cfg, maybe=False))


@pytest.mark.parametrize("mode", MODES)
def test_batch_of_frames_each_as_jax(mode):
    """Four frames at once, one of them under budget and one with no
    valid row: each frame's mask equals JAX's for that frame alone."""
    rng = np.random.default_rng(7)
    n, budget = 300, 60
    frames = [_frame(rng, n, 4), _frame(rng, n, 4, p_valid=0.15),
              _frame(rng, n, 4, ties=False), _frame(rng, n, 4, p_valid=0.0)]
    cfg = SiftConfig(filter_max_extrema=budget, filter_grid_size=2,
                     grid_filter_mode=mode)
    stack = [np.stack(a) for a in zip(*frames)]
    got = _port_keep(*stack, cfg)
    assert got.shape == (4, n)
    for f, (cell, sigma, valid) in enumerate(frames):
        assert np.array_equal(got[f], _jax_keep(cell, sigma, valid, cfg)), f
    assert np.array_equal(got[1], frames[1][2])    # 45 valid: under 1.1 x 60
    assert not got[3].any()


def test_redistributed_limit_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        counts = rng.integers(0, 200, 9).astype(np.int32)
        budget = int(rng.integers(1, 900))
        want = int(jgf._redistributed_limit(jnp.asarray(counts), budget))
        got = tgf._redistributed_limit(torch.from_numpy(
            counts.astype(np.int64))[None], budget)
        assert got.shape == (1,) and int(got[0]) == want


def test_apply_grid_filter_per_octave():
    from popsift_tpu_torch.ops.extrema import OctaveExtrema
    rng = np.random.default_rng(11)
    cell, sigma, valid = _frame(rng, 200, 4)
    cfg = SiftConfig(filter_max_extrema=30, grid_filter_mode="smallest")
    t = lambda a: torch.from_numpy(np.asarray(a))
    ext = OctaveExtrema(x=t(sigma), y=t(sigma), s=t(sigma),
                        level=t(cell.astype(np.int64)), sigma=t(sigma),
                        cell=t(cell.astype(np.int64)), valid=t(valid),
                        count=t(valid.sum()), n_candidates=t(200),
                        n_dropped=t(0))
    out = tgf.apply_grid_filter(ext, _port(cfg))
    want = _jax_keep(cell, sigma, valid, cfg)
    assert np.array_equal(out.valid.numpy(), want)
    assert int(out.count) == int(want.sum())


def test_grid_filter_redistributes_budget():
    """Port of test_variants.py::test_grid_filter_redistributes_budget."""
    rng = np.random.default_rng(5)
    counts = [300, 20, 15, 10]
    cells = np.concatenate([np.full(c, i) for i, c in enumerate(counts)])
    sigmas = rng.uniform(1.0, 8.0, cells.shape[0]).astype(np.float32)
    valid = np.ones(cells.shape[0], bool)
    cfg = SiftConfig(filter_max_extrema=200, filter_grid_size=2,
                     grid_filter_mode="largest")
    keep = _port_keep(cells, sigmas, valid, cfg, maybe=False)
    for c in (1, 2, 3):
        assert keep[cells == c].sum() == counts[c]
    assert keep[cells == 0].sum() == 155
    assert np.array_equal(keep, _ref_gridfilter_numpy(cells, sigmas, valid,
                                                      200, 4))


def test_grid_filter_two_dense_cells():
    """Port of test_variants.py::test_grid_filter_two_dense_cells."""
    rng = np.random.default_rng(9)
    counts = [120, 100, 8, 4]
    cells = np.concatenate([np.full(c, i) for i, c in enumerate(counts)])
    sigmas = rng.uniform(1.0, 8.0, cells.shape[0]).astype(np.float32)
    valid = np.ones(cells.shape[0], bool)
    cfg = SiftConfig(filter_max_extrema=100, filter_grid_size=2,
                     grid_filter_mode="smallest")
    keep = _port_keep(cells, sigmas, valid, cfg, maybe=False)
    assert np.array_equal(keep, _ref_gridfilter_numpy(
        cells, sigmas, valid, 100, 4, mode="smallest"))


def test_grid_filter_under_budget_keeps_all():
    """Port of test_variants.py::test_grid_filter_under_budget_keeps_all."""
    cells = np.array([0, 0, 1, 2, 3], np.int32)
    cfg = SiftConfig(filter_max_extrema=100, filter_grid_size=2)
    assert _port_keep(cells, np.ones(5, np.float32), np.ones(5, bool), cfg,
                      maybe=False).all()


def test_grid_filter_random_mode_counts():
    """Port of test_variants.py::test_grid_filter_random_mode_counts."""
    rng = np.random.default_rng(13)
    counts = [200, 40, 30, 10]
    cells = np.concatenate([np.full(c, i) for i, c in enumerate(counts)])
    sigmas = rng.uniform(1.0, 8.0, cells.shape[0]).astype(np.float32)
    valid = np.ones(cells.shape[0], bool)
    cfg = SiftConfig(filter_max_extrema=150, filter_grid_size=2,
                     grid_filter_mode="random")
    keep = _port_keep(cells, sigmas, valid, cfg, maybe=False)
    want = _ref_gridfilter_numpy(cells, sigmas, valid, 150, 4)
    for c in range(4):
        assert keep[cells == c].sum() == want[cells == c].sum(), c
