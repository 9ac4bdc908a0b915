"""The candidate compaction of all octaves and frames against the JAX
package's ``_compact_mask``, on the CPU.

* ``compact_octaves`` on CPU tensors (its plain version, ``_compact_mask``
  per frame and octave) equals JAX ``_compact_mask`` on every segment,
  entry for entry: live rows, padding rows past ``n_found``, ``n_found``
  and ``n_dropped``;
* the kernel source ``csrc/compact.cu``, compiled for the CPU by
  ``popsift_tpu_torch/tools/host_mock.py``, equals the plain version on
  the same masks, every output bit for bit (it needs g++ and skips
  without it). A third level needs a mask of more than 8.4 M entries,
  minutes under the stand-in's one thread per CUDA thread, so the card
  tests (``test_torch_kernels_cuda.py::test_compact_kernel``) hold that
  case, and here only the plain version meets it.

Cases: small and large masks (the two branches of ``_compact_mask``), the
block clamp pinned and automatic, a saturated capacity, empty masks,
several octaves and frames in one call (frames whose masks start at
unaligned bytes), a run of 128 consecutive non-empty blocks (level 2
keeps 127 of them), masks of three frames that the kernel's count spreads
over two launch blocks a frame (more than 2048 blocks of 128 entries)
before the last of them selects, at recursion depths 1 and 2, small masks
with more non-empty blocks than one select step takes and with more words
of non-empty bits than a block has threads, a last block that keeps K
entries (its padding is not lane 0), and a mask large enough for a third
level. The source also runs with output rows that do not share an
alignment and with its indices kept in the scratch.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.ops import extrema as jext
from popsift_tpu_torch.ops.kernels import build
from popsift_tpu_torch.ops.kernels import compact as C
from popsift_tpu_torch.tools import host_mock

torch.set_num_threads(1)


def _sparse(rng, shape, density, clusters=0):
    m = rng.random(shape) < density
    flat = m.reshape(-1)
    for c in rng.integers(0, max(1, flat.size - 64), size=clusters):
        flat[c:c + 40] = True          # dense runs inside one 128-block
    return m


def _run128():
    """Blocks 128..255 each hold one candidate: one full group of 128
    non-empty blocks at level 2."""
    m = np.zeros((700, 128), bool)
    m[128:256, 5] = True
    m[300:310, 77] = True
    m[0, 10] = True
    return m[None, None]


def _case(name):
    """(masks as bool numpy [F, Z, H, W] per octave, caps, block_k)."""
    rng = np.random.default_rng(len(name))
    if name == "small":
        return [_sparse(rng, (1, 3, 40, 60), 0.01)], (256,), 0
    if name == "small_pinned":
        return [_sparse(rng, (1, 3, 40, 60), 0.01, 6)], (512,), 2
    if name == "large":
        return [_sparse(rng, (1, 3, 100, 256), 0.003)], (64,), 0
    if name == "large_pinned":
        return [_sparse(rng, (1, 3, 100, 256), 0.002, 5)], (96,), 3
    if name == "saturated":
        return [_sparse(rng, (2, 3, 60, 80), 0.02),
                _sparse(rng, (2, 3, 100, 256), 0.01)], (32, 64), 0
    if name == "empty":
        return [np.zeros((2, 3, 40, 60), bool),
                np.zeros((2, 3, 100, 256), bool)], (256, 64), 0
    if name == "octaves_frames":
        shapes = [(3, 64, 80), (3, 32, 40), (3, 17, 30), (3, 9, 15)]
        return [_sparse(rng, (3, *s), 0.02) for s in shapes], \
            (256, 96, 32, 16), 0
    if name == "run128":
        return [_run128()], (200,), 0
    if name == "split_depth1":
        return [_sparse(rng, (3, 3, 299, 299), 0.002, 4)], (1536,), 0
    if name == "split_depth2":
        return [_sparse(rng, (3, 3, 299, 299), 0.003, 3),
                _sparse(rng, (3, 3, 100, 128), 0.01)], (64, 96), 0
    if name == "last_full":
        # the last block keeps K = 2 of its entries: every padding entry is
        # its entry of rank K-1
        m = _sparse(rng, (1, 3, 40, 64), 0.002)
        m.reshape(-1)[-128:-100] = True
        return [m], (64,), 2
    if name == "dense_small":
        # more non-empty blocks than one select step takes (4096)
        return [_sparse(rng, (1, 3, 400, 512), 0.05)], (2400,), 0
    if name == "wide_small":
        # a small mask with more words of "non-empty" bits than threads
        return [_sparse(rng, (1, 3, 1000, 1500), 0.0005, 2)], (17600,), 0
    if name == "deep":
        m = _sparse(rng, (1, 3, 1500, 1900), 0.00002)
        m[0, 1, 700, 100:1000:7] = True
        return [m], (64,), 0
    raise KeyError(name)


CASES = ["small", "small_pinned", "large", "large_pinned", "saturated",
         "empty", "octaves_frames", "run128", "split_depth1", "split_depth2",
         "dense_small", "wide_small", "last_full"]


def _plain(masks, caps, block_k):
    F = masks[0].shape[0]
    return C.compact_octaves([torch.from_numpy(m) for m in masks], caps,
                             block_k, F)


@pytest.mark.parametrize("name", CASES + ["deep"])
def test_compaction_matches_jax(name):
    masks, caps, block_k = _case(name)
    F = masks[0].shape[0]
    x0, y0, z0, n_found, n_dropped = _plain(masks, caps, block_k)
    offs = np.concatenate([[0], np.cumsum(caps)])
    assert x0.dtype == torch.int32 and n_found.dtype == torch.int64
    assert n_found.shape == (F, len(masks)) == n_dropped.shape
    for f in range(F):
        for o, (m, cap) in enumerate(zip(masks, caps)):
            _, H, W = m.shape[1:]
            idx, jn, jd = (np.asarray(a) for a in jext._compact_mask(
                jnp.asarray(m[f].reshape(-1)), cap, block_k=block_k))
            rows = slice(f * offs[-1] + offs[o], f * offs[-1] + offs[o + 1])
            assert int(n_found[f, o]) == int(jn), (f, o)
            assert int(n_dropped[f, o]) == int(jd), (f, o)
            assert np.array_equal(x0[rows].numpy(), idx % W), (f, o)
            assert np.array_equal(y0[rows].numpy(), idx % (H * W) // W)
            assert np.array_equal(z0[rows].numpy(), idx // (H * W) + 1)
    if name in ("small_pinned", "large_pinned", "run128"):
        assert int(n_dropped.sum()) > 0      # the clamps really dropped
    if name == "saturated":
        assert bool((n_found == torch.tensor(caps)).all())
    if name == "deep":
        assert len(C.levels(masks[0][0].size, caps[0])) == 3
    if name in ("dense_small", "wide_small"):
        m = masks[0][0]
        nb = -(-m.size // C.B)
        assert len(C.levels(m.size, caps[0])) == 1
        ne = int(np.pad(m.reshape(-1), (0, nb * C.B - m.size))
                 .reshape(nb, C.B).any(1).sum())
        assert ne > 4096 if name == "dense_small" else -(-nb // 32) > 1024
    if name.startswith("split"):
        N = masks[0][0].size
        assert -(-N // C.B) > C.CTA_BLOCKS and N % 16   # two blocks, unaligned
        assert len(C.levels(N, caps[0])) == int(name[-1])


@pytest.fixture(scope="module")
def compact_lib():
    if host_mock.find_compiler() is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = ctypes.CDLL(host_mock.build("compact"))
    fn = lib.ps_compact_octaves
    fn.argtypes = list(build._SIGNATURES["ps_compact_octaves"])
    fn.restype = ctypes.c_int
    return lib


def _source(lib, masks, caps, block_k, shift=0):
    """The kernel source's outputs, every buffer filled with junk first;
    y0 starts ``shift`` entries past a 16-byte boundary."""
    F = masks[0].shape[0]
    tm = [torch.from_numpy(m).view(torch.uint8) for m in masks]
    layout, words, rows = C._layout(tuple(tuple(m.shape[1:]) for m in tm),
                                    tuple(caps), block_k, F)
    table = layout.copy()
    table[:, 0] = [m.data_ptr() for m in tm]
    scratch = torch.full((words,), -7, dtype=torch.int32)
    x0, y0, z0 = (torch.full((F * rows + 4,), -9, dtype=torch.int32)
                  for _ in range(3))
    x0, y0, z0 = x0[:F * rows], y0[shift:shift + F * rows], z0[:F * rows]
    n_found, n_dropped = (torch.full((F, len(tm)), -5, dtype=torch.int64)
                          for _ in range(2))
    assert lib.ps_compact_octaves(
        table.ctypes.data, len(tm), F, rows, scratch.data_ptr(),
        x0.data_ptr(), y0.data_ptr(), z0.data_ptr(), n_found.data_ptr(),
        n_dropped.data_ptr(), None) == 0
    return x0, y0, z0, n_found, n_dropped


@pytest.mark.parametrize("name", CASES)
def test_compaction_source_matches_plain(compact_lib, name):
    masks, caps, block_k = _case(name)
    got = _source(compact_lib, masks, caps, block_k)
    want = _plain(masks, caps, block_k)
    for field, a, b in zip(("x0", "y0", "z0", "n_found", "n_dropped"), got,
                           want):
        assert torch.equal(a, b), field


@pytest.mark.parametrize("name", ["saturated", "octaves_frames"])
def test_compaction_source_unaligned_rows(compact_lib, name):
    """Rows whose three outputs do not share an alignment are written one
    at a time, with the same values."""
    masks, caps, block_k = _case(name)
    got = _source(compact_lib, masks, caps, block_k, shift=1)
    want = _plain(masks, caps, block_k)
    for field, a, b in zip(("x0", "y0", "z0", "n_found", "n_dropped"), got,
                           want):
        assert torch.equal(a, b), field


@pytest.fixture(scope="module")
def compact_lib_scratch():
    """The source built to keep every segment's indices in its scratch,
    as it does where a capacity does not fit a block's shared memory."""
    if host_mock.find_compiler() is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = ctypes.CDLL(host_mock.build("compact",
                                      ("PS_COMPACT_IDX_SMEM_MAX=0",)))
    fn = lib.ps_compact_octaves
    fn.argtypes = list(build._SIGNATURES["ps_compact_octaves"])
    fn.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name", ["large_pinned", "saturated",
                                  "split_depth2"])
def test_compaction_source_scratch_indices(compact_lib_scratch, name):
    """Indices kept in the scratch give the same rows as in shared
    memory."""
    masks, caps, block_k = _case(name)
    got = _source(compact_lib_scratch, masks, caps, block_k)
    want = _plain(masks, caps, block_k)
    for field, a, b in zip(("x0", "y0", "z0", "n_found", "n_dropped"), got,
                           want):
        assert torch.equal(a, b), field


@pytest.mark.parametrize("bad", ["shape", "frames", "caps", "dtype"])
def test_compaction_checks_its_masks(bad):
    m = torch.zeros((2, 3, 8, 8), dtype=torch.bool)
    args = {"shape": ([m[0]], (16,), 0, 1), "frames": ([m], (16,), 0, 1),
            "caps": ([m], (16, 16), 0, 2),
            "dtype": ([m.float()], (16,), 0, 2)}[bad]
    with pytest.raises(ValueError, match="compact"):
        C.compact_octaves(*args)


@pytest.mark.parametrize("n,cap,depth", [(3 * 40 * 60, 256, 1),
                                         (128 * 513, 64, 2),
                                         (128 * 512, 64, 1),
                                         (3 * 1500 * 1900, 64, 3),
                                         (3 * 2160 * 3840, 8192, 2),
                                         (3 * 2160 * 3840, 256, 3)])
def test_levels_follow_the_recursion(n, cap, depth):
    """The levels the kernel walks are the recursion of ``_compact_mask``:
    a level is small when its blocks number at most max(2 cap, 512)."""
    assert len(C.levels(n, cap)) == depth
    _, words, rows = C._layout(((1, 1, n),), (cap,), 0, 2)
    assert rows == cap and words > 2 * (n // 32)
