"""popsift_tpu_torch.sfm.retrieval on the CPU: the three cases of
tests/test_retrieval.py through the port, and the port against
popsift_tpu.sfm.retrieval on the same inputs.

The port draws k-means' init scores from a torch generator; the parity
cases give it JAX's (``jax.random.uniform(PRNGKey(0), (N,))``, the draw
of ``kmeans``' default seed). Tolerances: centers within 1e-4 x the
largest center entry, signatures within 1e-5, shortlists equal pair for
pair, and tie order that of ``lax.top_k``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popsift_tpu.sfm import retrieval as J
from popsift_tpu_torch.sfm.retrieval import (build_signatures, kmeans,
                                             pair_shortlist, top_k,
                                             vlad_signature)

torch.set_num_threads(1)
CPU = dict(device="cpu")


def jax_scores(n: int, seed: int = 0) -> np.ndarray:
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))


def clusters(seed=0, n=512, k=8):
    rng = np.random.default_rng(seed)
    true_c = rng.normal(0, 1, (k, 128)).astype(np.float32) * 3
    pts = (true_c[rng.integers(0, k, n)]
           + 0.1 * rng.normal(size=(n, 128))).astype(np.float32)
    return true_c, pts


def sequence_descs():
    """tests/test_retrieval.py::test_shortlist_recall_on_sequence's 24
    images: image i samples scene regions [i, i+4)."""
    rng = np.random.default_rng(2)
    n_img, n_regions = 24, 28
    region_desc = {r: np.abs(rng.normal(
        size=(40, 128))).astype(np.float32) + 0.05
        for r in range(n_regions)}
    descs = {}
    for i in range(n_img):
        parts = [region_desc[r] + 0.05 * rng.normal(
            size=region_desc[r].shape).astype(np.float32)
            for r in range(i, i + 4)]
        d = np.concatenate(parts)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        descs[i] = d.astype(np.float32)
    return descs


def test_kmeans_recovers_clusters():
    true_c, pts = clusters()
    centers = kmeans(pts, np.ones(512, bool), k=8, iters=15, **CPU).numpy()
    d = np.linalg.norm(true_c[:, None] - centers[None], axis=2)
    assert (d.min(1) < 0.5).all(), d.min(1)


def test_vlad_signature_properties():
    rng = np.random.default_rng(1)
    desc = np.abs(rng.normal(size=(256, 128))).astype(np.float32)
    centers = kmeans(desc, np.ones(256, bool), k=16, **CPU)
    sig = vlad_signature(desc, np.ones(256, bool), centers, **CPU).numpy()
    assert sig.shape == (16 * 128,)
    assert abs(np.linalg.norm(sig) - 1.0) < 1e-5
    # padding-invariant
    descp = np.concatenate([desc, np.zeros((64, 128), np.float32)])
    vp = np.concatenate([np.ones(256, bool), np.zeros(64, bool)])
    sig2 = vlad_signature(descp, vp, centers, **CPU).numpy()
    np.testing.assert_allclose(sig2, sig, atol=1e-5)


def test_shortlist_recall_on_sequence():
    """Images overlap iff |i - j| < 4; the top-6 shortlist recovers >= 90 %
    of those pairs while proposing a small fraction of all pairs."""
    descs = sequence_descs()
    n_img = len(descs)
    pairs = pair_shortlist(build_signatures(descs, k=32, **CPU), top_m=6,
                           **CPU)
    true_pairs = set((i, j) for i in range(n_img)
                     for j in range(i + 1, n_img) if j - i < 4)
    recall = len(set(pairs) & true_pairs) / len(true_pairs)
    assert recall >= 0.9, recall
    assert len(pairs) <= 6 * n_img
    assert len(pairs) < n_img * (n_img - 1) // 2 * 0.6


@pytest.mark.parametrize("k,iters,true_k,valid_rows",
                         [(8, 15, 8, 512), (32, 10, 8, 512),
                          (16, 10, 16, 400)],
                         ids=["k8", "k32", "k16_masked"])
def test_kmeans_matches_jax(k, iters, true_k, valid_rows):
    """From JAX's init scores: centers within 1e-4 x the largest entry
    (k=32 over 8 true clusters exercises the empty-cluster reseed, and a
    mask leaves rows out). Where two centers start in one true cluster
    (k=16 over 8, a mask), a point's nearer center is a rounding tie
    between XLA's products and torch's, so the masked case has as many
    true clusters as centers."""
    _, pts = clusters(k=true_k)
    valid = np.arange(512) < valid_rows
    want = np.asarray(J.kmeans(jnp.asarray(pts), jnp.asarray(valid), k=k,
                               iters=iters))
    got = kmeans(pts, valid, k=k, iters=iters, scores=jax_scores(512),
                 **CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_vlad_signature_matches_jax():
    """On JAX's centers, descriptors other than the codebook's sample,
    with padding rows: within 1e-5."""
    true_c, pts = clusters()
    centers = np.asarray(J.kmeans(jnp.asarray(pts), jnp.ones(512, bool),
                                  k=8, iters=15))
    rng = np.random.default_rng(4)
    q = (true_c[rng.integers(0, 8, 300)]
         + 0.3 * rng.normal(size=(300, 128))).astype(np.float32)
    q[250:] = 0.0
    valid = np.arange(300) < 250
    want = np.asarray(J.vlad_signature(jnp.asarray(q), jnp.asarray(valid),
                                       jnp.asarray(centers)))
    got = vlad_signature(q, valid, centers, **CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_build_signatures_and_shortlist_match_jax():
    """The 24-image sequence: signatures within 1e-5 of JAX's (the sample
    drawn by the same numpy generator, JAX's k-means scores), and the
    shortlist equal pair for pair at top 6 and top 3."""
    descs = sequence_descs()
    want = J.build_signatures(descs, k=32)
    n = min(4096, sum(len(d) for d in descs.values()))
    got = build_signatures(descs, k=32, scores=jax_scores(n), **CPU).numpy()
    assert got.shape == want.shape == (24, 32 * 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for m in (6, 3):
        assert pair_shortlist(got, top_m=m, **CPU) \
            == J.pair_shortlist(want, top_m=m)


def test_pair_shortlist_ties_toward_the_lower_index():
    """Equal similarities: JAX's ``lax.top_k`` keeps the lower index and
    ranks +0.0 above -0.0 (the floats' total order), and so does the
    port's ``top_k``."""
    sigs = np.zeros((6, 4), np.float32)
    sigs[:, 0] = 1.0                 # every pair equally similar
    assert pair_shortlist(sigs, top_m=2, **CPU) \
        == J.pair_shortlist(sigs, top_m=2)
    vals = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0, -0.0, 0.0])
    want = np.asarray(jax.lax.top_k(jnp.asarray(vals.numpy()), 7)[1])
    assert top_k(vals, 7).tolist() == want.tolist()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        kmeans(np.zeros((64, 128), np.float32), np.ones(64, bool), k=4)
