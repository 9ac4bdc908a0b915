"""Data-parallel batched extraction, ring matching and all-pairs matching.

Port of :mod:`popsift_tpu.parallel.batch`. A batch of B images is split
over the ranks of a mesh axis (B/n consecutive images a rank), every
rank extracts its shard with the port's ``extract_batch`` (the main
path's kernels, one launch each per shard), and cross-image matching
moves descriptors, not images, between ranks with :func:`ppermute`.
Where JAX ``vmap``s the matcher over pairs, a rank loops over its pairs.
The returned callables take this rank's shard; :func:`gather_features`
rebuilds the whole batch on every rank.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig
from ..ops.matching import RATIO, MatchResult, match_descriptors
from ..pipeline import build_extract_plan, extract_batch
from .mesh import Mesh, all_gather, axis_index, ppermute


def _stacked(results: list) -> MatchResult:
    return MatchResult(*(torch.stack(f) for f in zip(*results)))


def make_batched_extract_fn(cfg: SiftConfig, height: int, width: int,
                            mesh: Mesh, axis_name: str = "dp",
                            match_pairs: bool = False,
                            octave_caps: tuple | None = None):
    """fn: this rank's shard uint8[B/n, H, W] -> (its SiftFeatures with a
    leading [B/n] axis, ring matches or None).

    With ``match_pairs`` image i's descriptors are matched against image
    (i+1) mod B's (the SfM front end's sequential pairs): a rank's last
    image pairs with the next rank's first, whose descriptors come from
    there by :func:`ppermute`. The matches have one row a local image."""
    plan = build_extract_plan(cfg, height, width, octave_caps=octave_caps)

    def run(imgs):
        feats = extract_batch(imgs, plan, mesh.device)
        return feats, (ring_matches(feats, mesh, axis_name) if match_pairs
                       else None)

    return run


def ring_matches(feats, mesh: Mesh, axis_name: str = "dp") -> MatchResult:
    """The ring matches of this rank's shard of extracted features: local
    image i against image i+1, the last against the next rank's first
    (its descriptors fetched by :func:`ppermute` from the right
    neighbour). One row a local image."""
    n = mesh.shape[axis_name]
    perm = [(i, (i - 1) % n) for i in range(n)]    # send to left neighbour
    nbr_desc = ppermute(feats.desc[:1], mesh, perm, axis_name)
    nbr_valid = ppermute(feats.desc_valid[:1], mesh, perm, axis_name)
    right_desc = torch.cat([feats.desc[1:], nbr_desc])
    right_valid = torch.cat([feats.desc_valid[1:], nbr_valid])
    return _stacked([
        match_descriptors(feats.desc[b], feats.desc_valid[b],
                          right_desc[b], right_valid[b], tile=2048)
        for b in range(feats.desc.shape[0])])


def gather_features(feats, mesh: Mesh, axis_name: str | None = None):
    """A per-rank result with a leading image axis (``SiftFeatures``,
    ``MatchResult`` or any NamedTuple of tensors) for the whole batch, in
    rank order, on every rank."""
    return type(feats)(*(all_gather(f, mesh, tiled=True,
                                    axis_name=axis_name) for f in feats))


def make_allpairs_match_fn(mesh: Mesh, axis_name: str = "dp",
                           ratio: float | None = None, tile: int = 2048):
    """Block-sharded exhaustive pairwise matching (the O(N^2) SfM front
    end).

    fn: this rank's block (desc f32[B, C, 128], valid bool[B, C]) ->
    MatchResult of [B, n*B, C] tensors: row i is local image i's
    descriptors matched against every image j of the batch (its own
    image included; the caller ignores that self-match).

    Systolic ring: each rank keeps its left block and matches it against
    the right block in hand, then passes that block to rank + 1; after n
    steps it has met every block, with one extra block in flight a rank.
    The per-pair matcher is ``ops/matching.py::match_descriptors``."""
    ratio = RATIO if ratio is None else ratio
    n = mesh.shape[axis_name]
    perm = [(i, (i + 1) % n) for i in range(n)]

    def pair_block(desc, valid, rd, rv):
        # all (left i, right j) pairs of the resident and the streamed block
        return _stacked([_stacked([
            match_descriptors(desc[i], valid[i], rd[j], rv[j], ratio=ratio,
                              tile=tile) for j in range(rd.shape[0])])
            for i in range(desc.shape[0])])

    def run(desc, valid):
        me = axis_index(mesh, axis_name)
        rd, rv = desc, valid
        steps = []
        for k in range(n):
            steps.append(pair_block(desc, valid, rd, rv))
            if k + 1 < n:
                rd = ppermute(rd, mesh, perm, axis_name)
                rv = ppermute(rv, mesh, perm, axis_name)

        # step k matched the block owned by rank (me - k) mod n; reversed
        # and rolled by me + 1, owner o lands at position o
        def by_owner(*a):
            a = torch.roll(torch.stack(a).flip(0), me + 1, 0)
            a = a.movedim(0, 1)                      # [B, n, B, C, ...]
            return a.reshape(a.shape[0], n * a.shape[2], *a.shape[3:])

        return MatchResult(*(by_owner(*f) for f in zip(*steps)))

    return run
