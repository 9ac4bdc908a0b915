"""Brute-force descriptor matching.

Port of :mod:`popsift_tpu.ops.matching` (the reference's
FeaturesDev::match, features.cu:163-302). The distance field

    d2[i, j] = |l_i|^2 + |r_j|^2 - 2 l_i . r_j

is reduced to a (best, second-best) per left row; acceptance is Lowe's
ratio test on squared L2 at 0.8 (features.cu:223). The JAX package
computes all of it in XLA, outside any Pallas kernel. The exact
matcher's product and selection are ``ops/kernels/match.py``: on the
CPU its plain version (one f32 ``torch.matmul`` a tile of the right
set, the rest elementwise), on a CUDA device one hand-written kernel
that keeps the field in registers (``csrc/match.cu``).

What must agree with JAX beyond the arithmetic:
- every product runs in full f32 whatever torch's TF32 switch says
  (``utils.f32.full_f32``; JAX asks for ``Precision.HIGHEST``);
- a tile's best and second come from the first minimal column, that
  column masked by a compare, and the first minimal column again;
- the running pair and the tile's pair merge by a *stable* sort of the
  four candidates (``jnp.argsort`` is stable): among equal distances the
  earlier candidate wins, which decides ``second_idx`` wherever
  ``second_dist`` is ``inf``. The kernel's lexicographic rule on
  (distance, column) from the carry (inf, 0), (inf, 0) gives the same
  indices.

Results index the capacity-padded right set and have one row per padded
left row; padding rows are excluded by the validity masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.f32 import div, full_f32
from ..utils.profiling import count, span
from .kernels import match as kmatch
from .kernels.match import _scan_tiles, _top2

RATIO = 0.8  # features.cu:223
_BIG = 2 ** 31 - 1           # "no candidate" in the q8 matcher's int32 distances
_FIELD = 1 << 28             # entries of one chunk of the pruned matcher's sketch field


class MatchResult(NamedTuple):
    best_idx: torch.Tensor     # i64[L] index into the right set
    second_idx: torch.Tensor   # i64[L]
    best_dist: torch.Tensor    # f32[L] squared L2
    second_dist: torch.Tensor  # f32[L]
    accept: torch.Tensor       # bool[L] ratio test + validity


def _accept(b_d, s_d, valid_l, ratio):
    return ((b_d / s_d.clamp(min=1e-30) < ratio) & valid_l
            & torch.isfinite(b_d) & torch.isfinite(s_d))


@full_f32()
def match_descriptors(desc_l: torch.Tensor, valid_l: torch.Tensor,
                      desc_r: torch.Tensor, valid_r: torch.Tensor,
                      ratio: float = RATIO, tile: int = 4096) -> MatchResult:
    """Best/second-best search with the ratio test.

    desc_l: f32[L, 128]; desc_r: f32[R, 128]; the validity masks exclude
    capacity padding. On the CPU the right set is processed in tiles of
    ``tile`` rows (the last one ragged), the left set whole; on a CUDA
    device the kernel computes every pair of the padded sets, whatever
    ``tile``. Counted: ``match.calls``, and ``match.kernel`` for a call
    that launched the kernel."""
    with span("match"):
        count("match.calls")
        before = kmatch.launches
        b_d, b_i, s_d, s_i = kmatch.match_top2(desc_l, desc_r, valid_r, tile)
        count("match.kernel", kmatch.launches - before)
        return MatchResult(best_idx=b_i, second_idx=s_i, best_dist=b_d,
                           second_dist=s_d,
                           accept=_accept(b_d, s_d, valid_l, ratio))


def match_brute_small(desc_l, valid_l, desc_r, valid_r, ratio=RATIO):
    """Reference-shaped O(L*R) form for cross-checking the tiled matcher
    in tests (mirrors compute_distance, features.cu:184-226)."""
    d2 = torch.sum((desc_l[:, None, :] - desc_r[None, :, :]) ** 2, -1)
    b_d, b_i, s_d, s_i = _top2(
        torch.where(valid_r[None, :], d2, math.inf), math.inf)
    return MatchResult(b_i, s_i, b_d, s_d,
                       _accept(b_d, s_d, valid_l, ratio))


@full_f32()
def match_descriptors_q8(desc_l: torch.Tensor, valid_l: torch.Tensor,
                         desc_r: torch.Tensor, valid_r: torch.Tensor,
                         ratio: float = RATIO,
                         tile: int = 4096) -> MatchResult:
    """Int8-quantized variant of :func:`match_descriptors`.

    Descriptors are scaled to [0, 127] and rounded, and the squared
    distances are exact integers, as JAX's int8 x int8 -> int32
    ``dot_general`` gives them: here they are f32 products of the
    integer values, exact because every partial sum stays below
    128 * 127^2 = 2,064,512 < 2^24, then held as int32. The ratio test
    is scale-invariant, so acceptance survives quantization up to
    rounding of near-ties. Distances are returned dequantized.
    """
    L, R = desc_l.shape[0], desc_r.shape[0]
    scale = torch.maximum(
        torch.where(valid_l[:, None], desc_l, 0.0).max(),
        torch.where(valid_r[:, None], desc_r, 0.0).max()).clamp(min=1e-12)
    ql = torch.round(desc_l / scale * 127.0).clamp(0, 127)
    qr = torch.round(desc_r / scale * 127.0).clamp(0, 127)
    l_sq = torch.sum(ql * ql, 1, keepdim=True)

    def tile_dist(a, b):
        qt = qr[a:b]
        d2 = l_sq + torch.sum(qt * qt, 1)[None, :] - 2.0 * (ql @ qt.T)
        return torch.where(valid_r[None, a:b], d2.to(torch.int32), _BIG)

    b_d, b_i, s_d, s_i = _scan_tiles(tile_dist, L, R, min(tile, R), _BIG,
                                     torch.int32, desc_l.device)
    ok = (b_d < _BIG) & (s_d < _BIG)
    bf, sf = b_d.to(torch.float32), s_d.to(torch.float32)
    accept = (bf / sf.clamp(min=1.0) < ratio) & valid_l & ok
    deq = div(scale, 127.0)
    deq = deq * deq
    return MatchResult(best_idx=b_i, second_idx=s_i, best_dist=bf * deq,
                       second_dist=sf * deq, accept=accept)


# ---------------------------------------------------------------------------
# Cascade-style pruned matching (SfM scale)
# ---------------------------------------------------------------------------

@full_f32()
def sketch_basis(desc: torch.Tensor, valid: torch.Tensor, dim: int = 16):
    """PCA sketch basis for descriptor pruning: (P f32[128, dim], the
    orthonormal eigenvectors of the ``dim`` largest eigenvalues of the
    masked covariance, ascending; mu f32[128], the masked mean). The
    orthonormal projection makes the sketch distance a lower bound of
    the true squared L2. Eigenvector signs, and the basis inside a
    degenerate eigenvalue, depend on the eigensolver; ``P @ P.T`` does
    not."""
    w = valid.to(desc.dtype)
    n = torch.sum(w).clamp(min=1.0)
    mu = torch.sum(desc * w[:, None], 0) / n
    X = (desc - mu) * w[:, None]
    _, vecs = torch.linalg.eigh(X.T @ X)                     # ascending
    return vecs[:, -dim:], mu


def _smallest(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of the ``k`` smallest entries of each row of f32 ``vals``,
    smallest first, ties toward the lower column (``lax.top_k`` of
    ``-vals``; ``torch.topk`` promises no tie order). Each entry becomes
    one unique i64 key, its f32 bits in an order-preserving form above
    its column."""
    bits = vals.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key = (key << 32) | torch.arange(vals.shape[1], device=vals.device)
    return torch.topk(key, k, 1, largest=False).values & 0xFFFFFFFF


@full_f32()
def match_descriptors_pruned(desc_l: torch.Tensor, valid_l: torch.Tensor,
                             desc_r: torch.Tensor, valid_r: torch.Tensor,
                             ratio: float = RATIO, sketch_dim: int = 16,
                             shortlist: int = 64) -> MatchResult:
    """Two-stage matcher: a ``sketch_dim``-d PCA sketch of both sets
    shortlists ``shortlist`` right rows per left row, and the exact
    128-d squared L2, top 2 and ratio test run only on the shortlist.

    Exact when ``shortlist >= R``; otherwise approximate (the sketch
    distance lower-bounds the true one, so near neighbours are rarely
    pruned). Left rows are processed in chunks that keep the sketch
    field under 2^28 entries; rows are independent, so the result is
    that of one pass."""
    L, R = desc_l.shape[0], desc_r.shape[0]
    C = min(shortlist, R)
    P, mu = sketch_basis(desc_r, valid_r, sketch_dim)
    sl = (desc_l - mu) @ P                                    # [L, S]
    sr = (desc_r - mu) @ P                                    # [R, S]
    ssl, ssr = torch.sum(sl * sl, 1), torch.sum(sr * sr, 1)
    parts = []
    step = max(1, _FIELD // max(R, 1))
    for a in range(0, L, step):
        b = min(a + step, L)
        s2 = ssl[a:b, None] + ssr[None, :] - 2.0 * (sl[a:b] @ sr.T)
        cand = _smallest(torch.where(valid_r[None, :], s2, math.inf), C)
        diff = desc_l[a:b, None, :] - desc_r[cand]            # [b-a, C, 128]
        d2 = torch.where(valid_r[cand], torch.sum(diff * diff, -1),
                         math.inf)
        b_d, b_c, s_d, s_c = _top2(d2, math.inf)
        parts.append((cand.gather(1, b_c[:, None])[:, 0],
                      cand.gather(1, s_c[:, None])[:, 0], b_d, s_d))
    b_i, s_i, b_d, s_d = (torch.cat(p) for p in zip(*parts))
    return MatchResult(best_idx=b_i, second_idx=s_i, best_dist=b_d,
                       second_dist=s_d,
                       accept=_accept(b_d, s_d, valid_l, ratio))
