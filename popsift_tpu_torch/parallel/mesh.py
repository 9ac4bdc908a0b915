"""Process meshes and the collectives that ``shard_map`` code uses.

Port of :mod:`popsift_tpu.parallel.mesh`. JAX runs a mesh of devices in
one program; here every rank is a process of a ``torch.distributed`` job
(:func:`popsift_tpu_torch.utils.device.init_distributed`, or
:func:`popsift_tpu_torch.parallel.launch.spawn`), and a :class:`Mesh` is
this process's view of it: its process group along each axis, its index
and the axis sizes, and its device. Every rank of the job builds every
mesh, in the same order (``dist.new_group`` is collective).

The collectives are plain functions on tensors, named as JAX's:
:func:`psum` (``all_reduce`` SUM), :func:`all_gather`, :func:`ppermute`
(``batch_isend_irecv``), :func:`axis_index` and :func:`axis_size`. On an
axis of size 1 each is the identity and calls neither NCCL nor gloo. On
NCCL a collective is queued on the card and nothing waits on the host.
On gloo a tensor on the card is copied to the host, sent, and copied
back (:func:`_to_wire`, :func:`_from_wire`): gloo is the transport of
ranks that share one GPU, and of CPU ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.device import device_report as _device_rows
from ..utils.device import nccl_ready, resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh: for each axis name, its size
    (``shape``, as JAX's ``Mesh.shape``), this rank's index along it
    (``coords``), the process group along it (``groups``) and the global
    ranks of that group in axis order (``ranks``); the rank's ``device``
    and the job's ``backend``."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    ranks: dict
    device: torch.device
    backend: str

    def axis(self, axis_name: str | None = None) -> str:
        """``axis_name``, or the only axis of a 1-D mesh."""
        if axis_name is None:
            if len(self.axis_names) != 1:
                raise ValueError(f"mesh axes {self.axis_names}: name one")
            return self.axis_names[0]
        if axis_name not in self.shape:
            raise ValueError(f"no axis {axis_name!r} in {self.axis_names}")
        return axis_name


def _job() -> tuple:
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed job: call "
                           "utils.device.init_distributed first")
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def _rank_device(device, rank: int) -> torch.device:
    """``device``, or this rank's default ``cuda:{LOCAL_RANK}``; made the
    current CUDA device."""
    import os
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _check_backend(backend: str, dev: torch.device, world: int) -> None:
    if backend == "nccl":
        why = nccl_ready(world)
        if dev.type != "cuda" or why is not None:
            raise RuntimeError(
                f"an NCCL mesh needs one GPU a rank ({why or dev}); run "
                f"ranks that share a GPU, or CPU ranks, with "
                f"backend=\"gloo\"")


def _build(axes: list, device) -> Mesh | None:
    """The mesh of ``axes`` [(name, [[global ranks of one group], ...])],
    every group created on every rank in the order given; None on a rank
    outside every group of the first axis."""
    rank, world, backend = _job()
    mine = {}
    for name, blocks in axes:
        for ranks in blocks:
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
            if rank in ranks:
                mine[name] = (group, tuple(ranks))
    if len(mine) != len(axes):
        return None
    dev = _rank_device(device, rank)
    _check_backend(backend, dev, world)
    names = tuple(name for name, _ in axes)
    return Mesh(axis_names=names,
                shape={n: len(mine[n][1]) for n in names},
                coords={n: mine[n][1].index(rank) for n in names},
                groups={n: mine[n][0] for n in names},
                ranks={n: mine[n][1] for n in names},
                device=dev, backend=backend)


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              device=None) -> Mesh | None:
    """1-D mesh over ranks [0, ``n_devices``) of the job (all of them by
    default). ``device`` is this rank's device, by default
    ``cuda:{LOCAL_RANK}``; pass ``"cpu"`` for CPU ranks. A rank outside
    the mesh gets None."""
    _, world, _ = _job()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    return _build([(axis_name, [list(range(n))])], device)


def make_mesh_2d(dp: int, mp: int, names=("dp", "mp"),
                 device=None) -> Mesh | None:
    """2-D mesh (data x model/spatial) over ranks [0, dp*mp), rank
    ``i * mp + j`` at (i, j): along ``names[0]`` the ranks of column j,
    along ``names[1]`` those of row i. A rank outside it gets None."""
    _, world, _ = _job()
    if dp * mp > world:
        raise ValueError(f"requested {dp * mp} devices, have {world}")
    cols = [[i * mp + j for i in range(dp)] for j in range(mp)]
    rows = [[i * mp + j for j in range(mp)] for i in range(dp)]
    return _build([(names[0], cols), (names[1], rows)], device)


def device_report() -> str:
    """Human-readable device listing (the JAX package's, one line a
    device this process sees)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return "\n".join(f"id={r['id']} kind={r['kind']} "
                     f"platform={r['platform']} process={rank}"
                     for r in _device_rows(verbose=False))


def axis_index(mesh: Mesh, axis_name: str | None = None) -> int:
    """This rank's index along the axis."""
    return mesh.coords[mesh.axis(axis_name)]


def axis_size(mesh: Mesh, axis_name: str | None = None) -> int:
    return mesh.shape[mesh.axis(axis_name)]


def _to_wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A fresh contiguous buffer holding ``x`` for the transport: on gloo
    a host copy of a tensor on the card; bool as uint8."""
    w = x.to(torch.uint8) if x.dtype == torch.bool else x
    if mesh.backend == "gloo" and w.is_cuda:
        return w.cpu().contiguous()
    return w.clone(memory_format=torch.contiguous_format)


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The transport's result back on ``like``'s device and dtype."""
    return w.to(device=like.device, dtype=like.dtype)


def psum(x: torch.Tensor, mesh: Mesh,
         axis_name: str | None = None) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank of it."""
    name = mesh.axis(axis_name)
    if mesh.shape[name] == 1:
        return x
    w = _to_wire(x, mesh)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.groups[name])
    return _from_wire(w, x)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: int = 0,
               tiled: bool = False,
               axis_name: str | None = None) -> torch.Tensor:
    """Every rank's ``x`` in axis order: stacked on a new dimension
    ``axis``, or with ``tiled`` concatenated along ``axis``."""
    name = mesh.axis(axis_name)
    n = mesh.shape[name]
    if n == 1:
        return x if tiled else x.unsqueeze(axis)
    w = _to_wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.groups[name])
    out = torch.cat(parts, axis) if tiled else torch.stack(parts, axis)
    return _from_wire(out, x)


def ppermute(x: torch.Tensor, mesh: Mesh, perm,
             axis_name: str | None = None) -> torch.Tensor:
    """Send ``x`` along the (source, destination) pairs of ``perm``
    (axis indices; each rank a source and a destination at most once):
    the result is what this rank received, zeros if nothing."""
    name = mesh.axis(axis_name)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: {perm} sends or receives twice")
    me, n = mesh.coords[name], mesh.shape[name]
    recv_from = [s for s, d in perm if d == me]
    send_to = [d for s, d in perm if s == me]
    if n == 1:
        return x if recv_from else torch.zeros_like(x)
    w = _to_wire(x, mesh)
    out = torch.zeros_like(w)
    group, ranks = mesh.groups[name], mesh.ranks[name]
    ops = []
    for d in send_to:
        if d != me:
            ops.append(dist.P2POp(dist.isend, w, ranks[d], group))
    for s in recv_from:
        if s == me:
            out.copy_(w)
        else:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(out, x)
