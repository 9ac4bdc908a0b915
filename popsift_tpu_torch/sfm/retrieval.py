"""Image retrieval for SfM pair selection: VLAD signatures on the device.

Port of :mod:`popsift_tpu.sfm.retrieval`. Exhaustive pairwise matching
is O(N^2) descriptor matmuls; the shortlist picks the likely-overlapping
pairs by a cheap global signature instead. Lloyd's k-means over a
descriptor sample and VLAD residual aggregation are dense products
(assignment = argmin of a [N, K] distance matrix, aggregation = a one-hot
[K, N] x [N, 128] product), and the shortlist is one [N_img, N_img]
similarity product + top-M. Every product runs in full f32
(``utils/f32.py::full_f32``: TF32 is process-wide).

Random draws. JAX's ``kmeans`` draws its init scores with
``jax.random.uniform(PRNGKey(seed), (N,))``. No torch generator
reproduces threefry, so the port draws them from a host
``torch.Generator`` seeded with ``seed`` (the same scores on the card and
on the CPU) and takes ``scores=`` so that a test can pass JAX's.

Ties. ``jnp.argmin`` / ``jnp.argmax`` and ``torch.argmin`` /
``torch.argmax`` all return the first index of the extremum; ``lax.top_k``
breaks ties toward the lower index, which ``torch.topk`` does not promise,
and ``lax.top_k`` orders by the floats' total order (+0.0 above -0.0),
so :func:`top_k` ranks unique integer keys (``ops/matching.py::_smallest``).

Padding. JAX pads each image's descriptors to a power of two so that its
jit recompiles stay bounded; the port has no jit and aggregates the valid
rows only (VLAD ignores padding rows, tests/test_retrieval.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.matching import _smallest
from ..utils.device import resolve_device
from ..utils.f32 import full_f32


def top_k(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of f32 ``vals`` along its last
    dimension, largest first, as ``lax.top_k`` orders them: by the
    floats' total order (+0.0 above -0.0), ties toward the lower index
    (the ``k`` smallest of ``-vals`` by ``ops/matching.py::_smallest``)."""
    rows = vals.reshape(-1, vals.shape[-1])
    return _smallest(-rows, k).reshape(vals.shape[:-1] + (k,))


def _as(x, dtype, dev) -> torch.Tensor:
    """An array or tensor as a ``dtype`` tensor on ``dev``."""
    return torch.as_tensor(x, dtype=dtype).to(dev)


def _assign(desc: torch.Tensor, centers: torch.Tensor):
    """The [N, k] squared distances up to each row's |d|^2 and each row's
    nearest center, as JAX computes them."""
    d2 = (torch.sum(centers * centers, 1)[None, :]
          - 2.0 * desc @ centers.T)
    return d2, torch.argmin(d2, dim=1)


def draw_scores(n: int, seed: int = 0) -> torch.Tensor:
    """f32[n] uniform init scores of :func:`kmeans` from a host generator
    seeded with ``seed`` (JAX: ``jax.random.uniform(PRNGKey(seed),
    (n,))``)."""
    return torch.rand(n, generator=torch.Generator().manual_seed(seed))


@full_f32()
def kmeans(desc, valid, k: int = 32, iters: int = 10, seed: int = 0,
           scores=None, device="cuda") -> torch.Tensor:
    """Lloyd's k-means on ``device``. desc f32[N, 128], valid bool[N] ->
    centers f32[k, 128] on ``device``.

    Init by farthest-first traversal from a random valid row (the row of
    the largest ``scores + valid``; ``scores`` defaults to
    :func:`draw_scores` of ``seed``). Assignment is the argmin of the
    dense [N, k] squared-distance matrix; the update a one-hot-product
    segment mean; an empty cluster is reseeded at the points farthest
    from their assigned centers (JAX's comments say why both).
    """
    dev = resolve_device(device)
    desc = _as(desc, torch.float32, dev)
    valid = _as(valid, torch.bool, dev)
    N = desc.shape[0]
    w = valid.to(torch.float32)
    if scores is None:
        scores = draw_scores(N, seed)
    scores = _as(scores, torch.float32, dev) + w
    # each pick stays on the device: a [1]-index gather, no read-back
    rows = [desc[torch.argmax(scores).reshape(1)]]
    mind2 = torch.sum((desc - rows[0]) ** 2, dim=1) * w
    for _ in range(1, k):
        rows.append(desc[torch.argmax(mind2).reshape(1)])
        d2 = torch.sum((desc - rows[-1]) ** 2, dim=1) * w
        mind2 = torch.minimum(mind2, d2)
    centers = torch.cat(rows)

    cols = torch.arange(k, device=dev)
    for _ in range(iters):
        d2, a = _assign(desc, centers)
        onehot = (a[:, None] == cols[None, :]).to(torch.float32) * w[:, None]
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ desc
        mind2 = torch.min(d2, dim=1).values * w
        far_idx = top_k(mind2, k)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              desc[far_idx])
    return centers


@full_f32()
def vlad_signature(desc, valid, centers, device="cuda") -> torch.Tensor:
    """VLAD: per-cluster residual sums, power + L2 normalized.

    desc f32[N, 128], valid bool[N], centers f32[K, 128] -> f32[K * 128]
    on ``device``.
    """
    dev = resolve_device(device)
    desc = _as(desc, torch.float32, dev)
    w = _as(valid, torch.bool, dev).to(torch.float32)
    centers = _as(centers, torch.float32, dev)
    k = centers.shape[0]
    _, a = _assign(desc, centers)
    onehot = ((a[:, None] == torch.arange(k, device=dev)[None, :])
              .to(torch.float32) * w[:, None])
    sums = onehot.T @ desc
    counts = torch.sum(onehot, dim=0)
    v = (sums - counts[:, None] * centers).reshape(-1)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


@full_f32()
def pair_shortlist(signatures, top_m: int = 10, device="cuda") -> list:
    """Top-``top_m`` most similar partners per image from the [N, D]
    signature matrix (one [N, N] product on ``device`` + top-M, whose
    indices are read back). Returns a sorted list of unique (i, j)
    pairs, i < j."""
    dev = resolve_device(device)
    sigs = _as(signatures, torch.float32, dev)
    n = sigs.shape[0]
    sim = sigs @ sigs.T - 2.0 * torch.eye(n, device=dev)   # exclude self
    idx = top_k(sim, min(top_m, n - 1)).cpu().numpy()
    pairs = set()
    for i in range(n):
        for j in idx[i]:
            if i != int(j):
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def train_codebook(descs: dict, k: int = 32, sample: int = 4096,
                   seed: int = 0, scores=None,
                   device="cuda") -> torch.Tensor:
    """The shared codebook f32[k, 128] on ``device`` for a dict image_id
    -> f32[Ni, 128] descriptor sets: :func:`kmeans` of a cross-image
    sample of ``sample`` rows (``np.random.default_rng(seed).choice``, as
    JAX draws it), its init from ``kmeans``' own seed 0 or ``scores``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool = np.concatenate([descs[i] for i in sorted(descs)])
    take = rng.choice(len(pool), size=min(sample, len(pool)),
                      replace=False)
    sample_desc = torch.from_numpy(np.ascontiguousarray(pool[take])).to(dev)
    return kmeans(sample_desc, torch.ones(len(take), dtype=torch.bool,
                                          device=dev),
                  k=k, scores=scores, device=dev)


def build_signatures(descs: dict, k: int = 32, sample: int = 4096,
                     seed: int = 0, scores=None,
                     device="cuda") -> torch.Tensor:
    """Signatures f32[N_img, k * 128] on ``device`` for a dict image_id
    -> f32[Ni, 128] descriptor sets, in sorted id order: every image
    aggregated against one codebook (:func:`train_codebook`; a SHARED
    codebook makes signatures comparable)."""
    dev = resolve_device(device)
    centers = train_codebook(descs, k=k, sample=sample, seed=seed,
                             scores=scores, device=dev)
    sigs = []
    for i in sorted(descs):
        d = torch.from_numpy(np.ascontiguousarray(descs[i],
                                                  np.float32)).to(dev)
        sigs.append(vlad_signature(
            d, torch.ones(len(d), dtype=torch.bool, device=dev), centers,
            device=dev))
    return torch.stack(sigs)
