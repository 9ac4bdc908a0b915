"""Start the ranks of a ``torch.distributed`` job on one host.

JAX runs a mesh of virtual devices in one process and needs no launcher;
here each rank is its own process. :func:`spawn` starts them with the
``spawn`` start method (a forked child cannot use CUDA), meets them
through a ``file://`` store in a fresh temporary directory (no port to
clash with another job on the host), sets each rank's device and calls
``fn(device, *args)`` on every rank after
:func:`popsift_tpu_torch.utils.device.init_distributed`. ``fn`` must be a
function of an importable module (a child imports it to unpickle it)
and return something picklable. ``fn`` and ``args`` reach the ranks
through a file in that directory, not through the pipe of each child's
start: a start blocks until its child has read what does not fit the
pipe, and a child reads only after its imports, so large arguments
would start the ranks one after another. A rank that raises, or a job
that outlives ``timeout``, kills every rank and raises in the caller.

Devices: ``"cpu"`` (every rank on the CPU, with one thread each, so that
several jobs on one machine do not oversubscribe its cores), ``"cuda"``
(rank r on ``cuda:r``) or ``"cuda:N"`` (every rank on that GPU: the
ranks then share it, which NCCL refuses, so such a job runs on gloo).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch

from ..utils.device import init_distributed


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank`` in a job started on ``device``."""
    if device == "cuda":
        return torch.device("cuda", rank)
    return torch.device(device)


def _rank_main(rank: int, world: int, backend: str, device: str,
               store: str, out_dir: str):
    import torch.distributed as dist
    with open(os.path.join(out_dir, "call.pkl"), "rb") as fh:
        fn, args = pickle.load(fh)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(dev.index if dev.type == "cuda"
                                     else rank),
                      LOCAL_WORLD_SIZE=str(world))
    init_distributed(num_processes=world, process_id=rank, backend=backend,
                     init_method=store)
    out = fn(dev, *args)
    dist.destroy_process_group()
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".part", path)


def spawn(fn, world_size: int, backend: str, device: str = "cuda",
          args: tuple = (), timeout: float = 300.0) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` new ranks of one job on
    ``backend`` and return each rank's result, in rank order."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="popsift_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        with open(os.path.join(tmp, "call.pkl"), "wb") as fh:
            pickle.dump((fn, tuple(args)), fh)
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(world_size, backend, device, store, tmp))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of "
                                       f"{fn.__module__}.{fn.__name__} took "
                                       f"over {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
