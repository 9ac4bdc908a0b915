"""The port's meshes, collectives and launcher (``parallel/mesh.py``,
``parallel/launch.py``, ``utils/device.py::init_distributed``) on gloo
CPU ranks against numpy.

At world sizes 1, 2 and 4 each rank holds x = arange(6).reshape(2, 3) +
10 * rank (``tools/rank_cases.py::collectives``): ``psum`` (f32 and
i64), ``all_gather`` stacked, tiled, tiled along axis 1 and of bools,
``ppermute`` both ways round the ring and along one pair; at world size 1
every collective is the identity and calls no backend; ``make_mesh_2d(2,
2)``'s subgroups reduce over the right ranks; ``init_distributed`` is
idempotent. Asking for NCCL where there is no GPU raises, and a failing
or hanging rank makes ``spawn`` kill every rank and raise.
"""

import os

import numpy as np
import pytest
import torch

from popsift_tpu_torch.parallel.launch import spawn
from popsift_tpu_torch.tools import rank_cases
from popsift_tpu_torch.utils.device import init_distributed

pytestmark = pytest.mark.distributed
SIZES = (1, 2, 4)


@pytest.fixture(scope="module")
def runs():
    return {n: spawn(rank_cases.collectives, n, "gloo", "cpu", timeout=120)
            for n in SIZES}


def _x(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank


@pytest.mark.parametrize("n", SIZES)
def test_psum(runs, n):
    want = sum(_x(r) for r in range(n))
    for r, out in enumerate(runs[n]):
        assert (out["me"], out["n"]) == (r, n)
        assert out["psum"].dtype == np.float32
        assert np.array_equal(out["psum"], want)
        assert out["psum_i64"].dtype == np.int64
        assert np.array_equal(out["psum_i64"], want.astype(np.int64))


@pytest.mark.parametrize("n", SIZES)
def test_all_gather(runs, n):
    xs = [_x(r) for r in range(n)]
    for out in runs[n]:
        assert np.array_equal(out["gather"], np.stack(xs))
        assert np.array_equal(out["gather_tiled"], np.concatenate(xs))
        assert np.array_equal(out["gather_axis1"], np.concatenate(xs, 1))
        assert out["gather_bool"].dtype == bool
        assert np.array_equal(out["gather_bool"], np.stack(xs) > 12)


@pytest.mark.parametrize("n", SIZES)
def test_ppermute(runs, n):
    for r, out in enumerate(runs[n]):
        assert np.array_equal(out["right"], _x((r - 1) % n))
        assert np.array_equal(out["left"], _x((r + 1) % n))
        want = _x(0) if r == n - 1 else np.zeros((2, 3), np.float32)
        assert np.array_equal(out["one_pair"], want)


def test_world_size_one_is_the_identity(runs):
    # the rank ran its collectives with every backend call refused
    assert runs[1][0]["same_objects"] is True


def test_mesh_2d_subgroups(runs):
    outs = runs[4]
    for r, out in enumerate(outs):
        i, j = divmod(r, 2)
        assert out["coords_2d"] == (i, j)
        # "dp" runs down column j, "mp" along row i
        assert np.array_equal(out["dp_sum"], _x(j) + _x(2 + j))
        assert np.array_equal(out["mp_sum"], _x(2 * i) + _x(2 * i + 1))
        assert np.array_equal(out["mp_gather"],
                              np.stack([_x(2 * i), _x(2 * i + 1)]))


@pytest.mark.parametrize("n", SIZES)
def test_init_is_idempotent_and_reports(runs, n):
    for r, out in enumerate(runs[n]):
        assert out["init_again"] == "gloo"
        assert out["report"].startswith("id=0 ")
        assert out["report"].endswith(f"process={r}")


def test_nccl_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    store = "file://" + os.path.join(tmp_path, "store")
    for backend in ("nccl", None):
        with pytest.raises(RuntimeError, match="gloo"):
            init_distributed(num_processes=1, process_id=0, backend=backend,
                             init_method=store)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        init_distributed(num_processes=1, process_id=0, backend="mpi",
                         init_method=store)


def test_a_failing_rank_stops_the_job():
    with pytest.raises(Exception, match="fails on purpose"):
        spawn(rank_cases.fail_on, 2, "gloo", "cpu", args=(1,), timeout=60)


def test_a_hanging_job_times_out():
    with pytest.raises(TimeoutError):
        spawn(rank_cases.hang, 2, "gloo", "cpu", args=(600,), timeout=5)
