"""Device selection and the device report.

Every public entry point of the port takes its device explicitly. A
request for a CUDA device on a machine without one raises: nothing falls
back to the CPU on its own, so a run that asked for the card either ran
on the card or failed. :func:`device_report` is the counterpart of the
JAX package's (the reference's ``device_prop_t`` printer,
common/device_prop.cu:18-87).
"""

from __future__ import annotations

import platform

import torch


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
