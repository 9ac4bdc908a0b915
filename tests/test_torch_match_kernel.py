"""The exact matcher's kernel (``csrc/match.cu``) on the CPU: its source
through the host mock against the plain version, the wrapper's CPU path
and counters, and the split of the right set into parts.

``popsift_tpu_torch/tools/host_mock.py`` compiles ``csrc/match.cu`` with
g++ against a stand-in for the CUDA runtime (one std::thread per CUDA
thread; a cp.async copy is made at once) and the tests call its C entry
on CPU tensors: the kernel's tiles, fragment layout, epilogue, shuffles
and merge of the parts run here. They need g++ and skip without it.
Tolerances: the planted ties bit-equal to the plain version in every
field; the parts bit-equal to one another; on random unit descriptors
``torch_card.match_differences`` (distances within ``MATCH_DIST_TOL``,
a column that differs only at a near-tie in f64).
"""

import ctypes

import numpy as np
import pytest
import torch

from popsift_tpu_torch.ops import matching as M
from popsift_tpu_torch.ops.kernels import build
from popsift_tpu_torch.ops.kernels import match as K
from popsift_tpu_torch.tools import host_mock
from popsift_tpu_torch.utils import profiling
from torch_card import match_differences, tie_case

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    if host_mock.find_compiler() is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = ctypes.CDLL(host_mock.build("match"))
    fn = lib.ps_match_top2
    fn.argtypes = list(build._SIGNATURES["ps_match_top2"])
    fn.restype = ctypes.c_int
    return lib


def _call(lib, dl, dr, vr, S):
    """The C entry on CPU tensors: (return code, best_d, best_i,
    second_d, second_i)."""
    L, R = dl.shape[0], dr.shape[0]
    out = (torch.empty(L), torch.empty(L, dtype=torch.int64),
           torch.empty(L), torch.empty(L, dtype=torch.int64))
    padded = 128 * (-(-L // 128) - (-R // 128))
    scratch = torch.empty(max(128 * padded + L + R + 4 * S * L, 1))
    rc = lib.ps_match_top2(dl.data_ptr(), L, dr.data_ptr(),
                           vr.view(torch.uint8).data_ptr(), R, S,
                           scratch.data_ptr(), *(o.data_ptr() for o in out),
                           None)
    return (rc, *out)


def _result(top2, valid_l):
    b_d, b_i, s_d, s_i = top2
    return M.MatchResult(b_i, s_i, b_d, s_d,
                         M._accept(b_d, s_d, valid_l, M.RATIO))


def _unit_sets(L: int, R: int, seed: int):
    """Non-negative unit descriptors (as RootSIFT's); half the smaller
    set planted in the other with noise, one left row twice exactly; a
    fifth of the right rows invalid, the planted ones valid."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    dl = unit(rng.random((L, 128)) ** 2)
    dr = unit(rng.random((R, 128)) ** 2)
    k = min(L, R) // 2
    src, dst = rng.permutation(L)[:k], rng.permutation(R)[:k]
    dr[dst] = unit(np.abs(dl[src] + rng.normal(0, 0.02, (k, 128))))
    vr = rng.random(R) >= 0.2
    vr[dst] = True
    if k >= 2:
        dr[dst[:2]] = dl[src[0]]
    vl = rng.random(L) >= 0.1
    return (torch.from_numpy(dl.astype(np.float32)), torch.from_numpy(vl),
            torch.from_numpy(dr.astype(np.float32)), torch.from_numpy(vr))


@pytest.mark.parametrize("L,R", [(300, 413), (1, 130), (129, 1), (257, 256),
                                 (130, 700)])
def test_match_source_equals_the_plain_version(lib, L, R):
    """Sets of sizes that are not multiples of the kernel's 128 rows,
    L != R, one row a side: every split of the right set gives the same
    bits, and the result is the plain version's up to near-ties; an
    exact duplicate reads 0."""
    dl, vl, dr, vr = _unit_sets(L, R, L + R)
    tiles = -(-R // 128)
    runs = [_call(lib, dl, dr, vr, S) for S in range(1, min(3, tiles) + 1)]
    for run in runs:
        assert run[0] == 0
        for a, b in zip(run[1:], runs[0][1:]):
            assert torch.equal(a, b)
    got = _result(runs[0][1:], vl)
    want = _result(K.match_top2_torch(dl, dr, vr, tile=100), vl)
    assert match_differences(got, want, dl, dr, vl) <= 1
    dup = ((dr[None] == dl[:, None]).all(-1) & vr[None]).any(1)
    assert (got.best_dist[dup] == 0).all()


@pytest.mark.parametrize("case", ["dupes", "one", "none"])
def test_match_source_planted_ties(lib, case):
    """Exact ties, the inf entries of invalid rows and the carry: every
    field of the kernel equals the plain version's, second_idx included;
    ``dupes`` rows 5 and 7 read (30, 35, 0.0, 0.0, True)."""
    dl, vl, dr, vr = (torch.from_numpy(a) for a in tie_case(case))
    rc, *top2 = _call(lib, dl, dr, vr, 1)
    assert rc == 0
    got = _result(top2, vl)
    want = _result(K.match_top2_torch(dl, dr, vr, tile=8), vl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "dupes":
        for row in (5, 7):
            assert (int(got.best_idx[row]), int(got.second_idx[row]),
                    float(got.best_dist[row]), float(got.second_dist[row]),
                    bool(got.accept[row])) == (30, 35, 0.0, 0.0, True)
    if case == "one":
        assert torch.isinf(got.second_dist).all()
        assert (got.second_idx == 0).all()


def test_match_source_refuses(lib):
    """No left or right row, no part, or more parts than right tiles:
    an error code and no launch."""
    dl, _, dr, vr = _unit_sets(8, 200, 1)
    assert _call(lib, dl[:0], dr, vr, 1)[0] != 0
    assert _call(lib, dl, dr[:0], vr[:0], 1)[0] != 0
    assert _call(lib, dl, dr, vr, 0)[0] != 0
    assert _call(lib, dl, dr, vr, 3)[0] != 0


@pytest.mark.parametrize("L,R,n_sm,want", [
    (29450, 29450, 132, 4),    # 231 blocks: 924 = 7 waves of 132
    (61440, 61440, 132, 3),
    (300, 413, 132, 4),        # one wave whatever the split: the most parts
    (300, 200, 132, 2),        # no more parts than right tiles
    (100000, 1000, 132, 1),
])
def test_parts(L, R, n_sm, want):
    assert K.parts(L, R, n_sm) == want


def test_cpu_call_takes_the_plain_path_and_counts():
    """A CPU call runs the plain version (every field equal to it),
    launches nothing and counts ``match.calls`` 1 and ``match.kernel``
    0 while tracing is on."""
    dl, vl, dr, vr = _unit_sets(40, 90, 3)
    before = K.launches
    profiling.reset()
    profiling.enable_tracing(True)
    try:
        got = M.match_descriptors(dl, vl, dr, vr, tile=32)
        counters = profiling.counters()
    finally:
        profiling.enable_tracing(False)
        profiling.reset()
    assert K.launches == before
    assert counters["match.calls"] == 1 and counters["match.kernel"] == 0
    want = _result(K.match_top2_torch(dl, dr, vr, tile=32), vl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_empty_sets_give_the_fill_values():
    """No left row: empty fields; no right row: every left row keeps the
    carry (inf, 0), (inf, 0) and accepts nothing."""
    dl, vl, dr, vr = _unit_sets(6, 10, 4)
    none = M.match_descriptors(dl[:0], vl[:0], dr, vr)
    assert all(f.shape == (0,) for f in none)
    got = M.match_descriptors(dl, vl, dr[:0], vr[:0])
    assert torch.isinf(got.best_dist).all() and torch.isinf(
        got.second_dist).all()
    assert not got.best_idx.any() and not got.second_idx.any()
    assert not got.accept.any()


def test_a_device_tensor_never_takes_the_plain_path():
    """Tensors off the CPU go to the kernel or raise: on a device that is
    not CUDA (``meta``) the wrapper raises and counts no launch."""
    dl, _, dr, vr = (t.to("meta") for t in _unit_sets(6, 10, 5))
    before = K.launches
    with pytest.raises(ValueError):
        K.match_top2(dl, dr, vr)
    assert K.launches == before
