"""The port's data-parallel layer (``parallel/batch.py``) on 4 gloo CPU
ranks against its single-process path and against the JAX package's
``shard_map`` version on ``make_mesh(4)`` of the conftest's virtual
devices; the port of tests/test_parallel.py.

* batched extraction of 8 frames, 2 a rank, gathered: equal to the
  port's single-process ``extract_batch`` bit for bit, and to JAX's
  ``make_batched_extract_fn`` within the golden tolerances
  (tests/test_golden.py:21-24) with equal counts;
* the ring matches of 8 shifted frames (tests/test_parallel.py:43-57):
  equal to the port's ``match_descriptors`` of the same pairs, and to
  JAX's ring on the valid rows (accept equal, ``best_idx`` equal where
  accepted);
* all-pairs matching of 8 sets of 48 planted descriptors
  (tests/test_parallel.py:60-98): every (i, j) pair equal to the port's
  ``match_brute_small`` and to JAX's ``make_allpairs_match_fn`` (accept
  equal, ``best_idx`` equal on accepted rows, ``best_dist`` within 1e-5);
* ``tools/dryrun_multichip.py`` at 2 ranks on the CPU, its spatially
  sharded pyramid and extraction (items 2 and 2b) included.

The ranks start once for the module (``parallel/launch.py::spawn``, rank
body ``tools/rank_cases.py::parallel_suite``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_image
from popsift_tpu.api import FeaturesHost as JaxFeaturesHost
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.matching import match_brute_small as jax_brute
from popsift_tpu.parallel.batch import (make_allpairs_match_fn,
                                        make_batched_extract_fn)
from popsift_tpu.parallel.mesh import make_mesh
from popsift_tpu_torch import api as tapi
from popsift_tpu_torch.ops.matching import (match_brute_small,
                                            match_descriptors)
from popsift_tpu_torch.parallel.launch import spawn
from popsift_tpu_torch.pipeline import (SiftFeatures, build_extract_plan,
                                        extract_batch, frame_features)
from popsift_tpu_torch.tools import rank_cases
from test_golden import _flatten_host
from test_torch_pipeline import (_assert_within_golden_tolerances,
                                 port_config)

pytestmark = pytest.mark.distributed
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B, RANKS = 48, 64, 8, 4
CFG = SiftConfig(octaves=2, extrema_capacity=128)
N, C, TILE = 8, 48, 32


def _planted_sets():
    """tests/test_parallel.py:60-79's descriptor sets."""
    rng = np.random.default_rng(7)
    desc = rng.normal(size=(N, C, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    for i in range(N):
        for j in range(i + 1, N):
            desc[j, (i * 3) % C] = desc[i, (j * 5) % C] + \
                rng.normal(scale=0.01, size=128).astype(np.float32)
    valid = rng.random((N, C)) < 0.9
    return desc, valid


@pytest.fixture(scope="module")
def inputs():
    frames = np.stack([synthetic_image(H, W, seed=i) for i in range(B)])
    base = synthetic_image(H, W, seed=1)
    rolled = np.stack([np.roll(base, (i, 2 * i), axis=(0, 1))
                       for i in range(B)])
    return frames, rolled, *_planted_sets()


@pytest.fixture(scope="module")
def ranks(inputs):
    return spawn(rank_cases.parallel_suite, RANKS, "gloo", "cpu",
                 args=(*inputs[:2], dataclasses.asdict(CFG), *inputs[2:],
                       TILE), timeout=240)


@pytest.fixture(scope="module")
def port_single(inputs):
    plan = build_extract_plan(port_config(CFG), H, W)
    return (extract_batch(inputs[0], plan, "cpu"),
            extract_batch(inputs[1], plan, "cpu"))


@pytest.fixture(scope="module")
def jax_runs(inputs):
    fn = make_batched_extract_fn(CFG, H, W, make_mesh(RANKS),
                                 match_pairs=True)
    return fn(inputs[0]), fn(inputs[1])


def _port_feats(d: dict) -> SiftFeatures:
    return SiftFeatures(**{k: torch.from_numpy(v) for k, v in d.items()})


def test_ranks_hold_the_same_gathered_batch(ranks):
    assert len(ranks) == RANKS
    for r in ranks:
        assert r["no_matches"]
        assert r["local_keypoints"].shape == (B // RANKS,)
        for key in ("feats", "ring_feats", "ring", "allpairs"):
            for name, v in r[key].items():
                assert np.array_equal(v, ranks[0][key][name]), (key, name)
    assert np.array_equal(
        np.concatenate([r["local_keypoints"] for r in ranks]),
        ranks[0]["feats"]["n_keypoints"])


def test_batched_extract_equals_single_process(ranks, port_single):
    got = ranks[0]["feats"]
    assert got["n_keypoints"].shape == (B,) and got["n_keypoints"].min() > 0
    for name, want in port_single[0]._asdict().items():
        assert got[name].dtype == want.numpy().dtype, name
        assert np.array_equal(got[name], want.numpy()), name


def test_batched_extract_matches_jax(ranks, jax_runs):
    (jfeats, _), _ = jax_runs
    got = _port_feats(ranks[0]["feats"])
    assert np.array_equal(got.n_keypoints.numpy(),
                          np.asarray(jfeats.n_keypoints))
    for i in range(B):
        mine = tapi.FeaturesHost(frame_features(got, i))
        ref = JaxFeaturesHost(jax.tree.map(lambda a: a[i], jfeats))
        assert mine.getFeatureCount() == ref.getFeatureCount() > 0
        assert mine.getDescriptorCount() == ref.getDescriptorCount()
        _assert_within_golden_tolerances(_flatten_host(mine),
                                          _flatten_host(ref))


def test_ring_matches_equal_single_process(ranks, port_single):
    ring = ranks[0]["ring"]
    rf = port_single[1]
    for name, want in rf._asdict().items():
        assert np.array_equal(ranks[0]["ring_feats"][name], want.numpy())
    assert ring["accept"].shape == rf.desc_valid.shape
    nvalid = rf.desc_valid.numpy().sum(1)
    for i in range(B):
        j = (i + 1) % B
        want = match_descriptors(rf.desc[i], rf.desc_valid[i], rf.desc[j],
                                 rf.desc_valid[j], tile=2048)
        for name, v in want._asdict().items():
            assert np.array_equal(ring[name][i], v.numpy()), (i, name)
        # every image is a small shift of the previous: pairs match
        assert ring["accept"][i].sum() > 0.3 * max(nvalid[i], 1)


def test_ring_matches_match_jax(ranks, jax_runs):
    _, (jfeats, jring) = jax_runs
    ring = ranks[0]["ring"]
    valid = ranks[0]["ring_feats"]["desc_valid"]
    assert np.array_equal(valid, np.asarray(jfeats.desc_valid))
    j_acc = np.asarray(jring.accept)
    for i in range(B):
        v = valid[i]
        assert np.array_equal(ring["accept"][i][v], j_acc[i][v]), i
        acc = ring["accept"][i]
        assert np.array_equal(ring["best_idx"][i][acc],
                              np.asarray(jring.best_idx[i])[acc]), i


def test_allpairs_equals_brute_and_jax(ranks, inputs):
    desc, valid = inputs[2:]
    got = ranks[0]["allpairs"]
    assert got["accept"].shape == (N, N, C)
    n_accepted = 0
    jres = make_allpairs_match_fn(make_mesh(RANKS), tile=TILE)(
        jnp.asarray(desc), jnp.asarray(valid))
    for i in range(N):
        for j in range(N):
            if i == j:
                continue
            want = match_brute_small(*(torch.from_numpy(a) for a in (
                desc[i], valid[i], desc[j], valid[j])))
            jwant = jax_brute(jnp.asarray(desc[i]), jnp.asarray(valid[i]),
                              jnp.asarray(desc[j]), jnp.asarray(valid[j]))
            acc = want.accept.numpy()
            n_accepted += int(acc.sum())
            for ref in (acc, np.asarray(jres.accept[i, j]),
                        np.asarray(jwant.accept)):
                assert np.array_equal(got["accept"][i, j], ref), (i, j)
            for ref in (want.best_idx.numpy(), np.asarray(jres.best_idx[i, j])):
                assert np.array_equal(got["best_idx"][i, j][acc], ref[acc])
            for ref in (want.best_dist.numpy(),
                        np.asarray(jres.best_dist[i, j])):
                np.testing.assert_allclose(got["best_dist"][i, j][acc],
                                           ref[acc], atol=1e-5)
    assert n_accepted >= N * (N - 1) // 2     # the planted pairs match


def test_dryrun_multichip_on_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "popsift_tpu_torch.tools.dryrun_multichip",
         "--world-size", "2", "--device", "cpu", "--backend", "gloo"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "dryrun_multichip: 2 ranks" in proc.stdout
    assert "spatial pyramid (6, 64, 64)" in proc.stdout
    assert "(equal to extract=True)" in proc.stdout
    assert "not yet ported" not in proc.stdout
