"""Device selection and the device report.

Every public entry point of the port takes its device explicitly. A
request for a CUDA device on a machine without one raises: nothing falls
back to the CPU on its own, so a run that asked for the card either ran
on the card or failed. :func:`device_report` is the counterpart of the
JAX package's (the reference's ``device_prop_t`` printer,
common/device_prop.cu:18-87), :func:`init_distributed` of its
``init_distributed`` (jax.distributed), on ``torch.distributed``.
"""

from __future__ import annotations

import datetime
import os
import platform

import torch

# how long the rendezvous and each collective wait for a lost rank
DIST_TIMEOUT_S = 60.0


def resolve_device(device) -> torch.device:
    """Return the ``torch.device`` for ``device`` ("cpu", "cuda",
    "cuda:N" or a ``torch.device``); raises RuntimeError when a CUDA
    device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def device_report(verbose: bool = True) -> list:
    """Return (and optionally print) one row per device, with the keys of
    popsift_tpu.utils.device.device_report: ``id``, ``platform``,
    ``kind``, ``process``, ``coords``, ``core_on_chip``, ``hbm_bytes``
    and ``hbm_in_use``. The CUDA devices come from
    ``torch.cuda.get_device_properties`` and ``torch.cuda.mem_get_info``;
    a machine without one lists its CPU, with no memory figures."""
    rows = []
    if torch.cuda.is_available():
        backend = "cuda"
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            free, total = torch.cuda.mem_get_info(i)
            rows.append({"id": i, "platform": "gpu", "kind": props.name,
                         "process": 0, "coords": None,
                         "core_on_chip": None, "hbm_bytes": int(total),
                         "hbm_in_use": int(total - free)})
    else:
        backend = "cpu"
        rows.append({"id": 0, "platform": "cpu",
                     "kind": platform.processor() or platform.machine(),
                     "process": 0, "coords": None, "core_on_chip": None,
                     "hbm_bytes": None, "hbm_in_use": None})
    if verbose:
        print(f"backend: {backend}  processes: 1  devices: {len(rows)} "
              f"(local {len(rows)})")
        for r in rows:
            hbm = r.get("hbm_bytes")
            hbm_s = f"{hbm / 2**30:.1f} GiB" if hbm else "?"
            print(f"  [{r['id']}] {r['kind']} (proc {r['process']}, "
                  f"coords {r['coords']}) hbm={hbm_s}")
    return rows


def nccl_ready(world_size: int) -> str | None:
    """None when NCCL can serve ``world_size`` ranks on this host (one GPU
    each), else why not."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if not dist.is_nccl_available():
        return "this torch is built without NCCL"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if torch.cuda.device_count() < local:
        return (f"{local} ranks on this host share "
                f"{torch.cuda.device_count()} GPU(s); NCCL needs one each")
    return None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, *,
                     init_method: str | None = None) -> str:
    """Join this process to the ``torch.distributed`` job and return its
    backend. Idempotent: on an initialised job it returns at once.

    ``coordinator="host:port"`` meets the other ranks over
    ``tcp://host:port`` (rank 0 listens there); ``init_method`` takes any
    URL instead (``file://`` for ranks of one host); with neither, the
    ``env://`` variables of torchrun (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) are read. ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.

    ``backend=None`` means ``"nccl"``, which needs a GPU for every rank
    of the host; on fewer GPUs than ranks, or on the CPU, pass
    ``backend="gloo"``. Nothing switches backend on its own: a request
    that cannot be met, or a failed NCCL init, raises. A collective that
    waits longer than ``DIST_TIMEOUT_S`` for a rank raises too."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_backend()
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if backend is None or backend == "nccl":
        why = nccl_ready(world)
        if why is not None:
            raise RuntimeError(
                f"NCCL cannot run {world} rank(s) here: {why}; pass "
                f"backend=\"gloo\" to run them on gloo")
        backend = "nccl"
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if init_method is None:
        init_method = (f"tcp://{coordinator}" if coordinator is not None
                       else "env://")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return backend
