"""Device mesh construction over ``torch.distributed``.

Counterpart of ``singlecarrier_tpu/parallel/mesh.py``.  The reference is
single-process and single-thread (SURVEY.md section 2: zero parallelism
code); all scaling here is one process per card (``torchrun``, or
``parallel.multihost.main``) and a ``DeviceMesh`` of shape ``(ch,
time)`` with dimension names ``("ch", "time")``.  The dominant axis is
``ch`` (independent RF channels, pure data parallelism; its group
carries the metric reductions); ``time`` shards one channel's stream
(sequence parallelism with a halo exchange, ``parallel/timeshard.py``),
and its sub-group carries the halos.

The backend follows the device rule: NCCL for the card, gloo for the
CPU; a caller may initialize gloo and keep CUDA tensors, whose halos then
go through host buffers (:func:`shift_right`).
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

AXES = ("ch", "time")


def backend_for(device) -> str:
    """The process-group backend of the device rule: NCCL for the card,
    gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def device_count() -> int:
    """The number of devices a mesh can span: the ranks of the default
    process group when one is initialized (one process per card, so the
    global count, as ``jax.devices()`` gives it), else
    ``torch.cuda.device_count()`` (the cards this process sees)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(ch: int | None = None, time: int = 1, devices=None, *,
              device=None) -> DeviceMesh:
    """Build a ``(ch, time)`` mesh over the default group's ranks.

    ``devices``: the ranks the mesh spans, in order (default: every rank
    of the default group).  ``ch`` defaults to all of them over ``time``
    (the channel axis is the scaling axis for the >=1M-channel target);
    ``ValueError`` where ``ch * time`` is not their number.  ``device``:
    where the mesh's tensors lie, the card unless it says otherwise
    (``"cpu"``), which raises where there is no card.

    Without an initialized process group a mesh of one rank initializes
    a one-rank group on a ``tcp://127.0.0.1`` store, its backend from
    ``device``; the caller ends it with
    ``torch.distributed.destroy_process_group()``.  Every rank of the
    group calls this alike: the sub-groups are made collectively.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        ranks = (list(range(dist.get_world_size())) if devices is None
                 else [int(r) for r in devices])
    else:
        ranks = [0] if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if ch is None:
        ch = n // time
    if ch * time != n:
        raise ValueError(f"mesh {ch}x{time} != {n} devices")
    if not dist.is_initialized():
        if ranks != [0]:
            raise ValueError("without a process group only a mesh of "
                             "rank 0 can be made")
        dist.init_process_group(backend_for(dev),
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(ch, time),
                      mesh_dim_names=AXES)


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card (raises where
    there is none), or the CPU."""
    if mesh.device_type == "cuda":
        return resolve_device(None)
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _through_host(group, t: torch.Tensor) -> bool:
    """Whether ``t`` crosses ``group`` through a host buffer: gloo's
    ``send`` / ``recv`` take CPU tensors only (PyTorch's backend table),
    so on a gloo group a CUDA tensor is copied to the host and back; on
    NCCL it stays on the card.  Decided by the group's backend, never by
    a failure."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def shift_right(x: torch.Tensor, mesh: DeviceMesh,
                axis: str = "time") -> torch.Tensor:
    """Send ``x`` to the right neighbour on ``axis`` and return what the
    left neighbour sent, zeros on the axis' first rank: ``lax.ppermute``
    with the pairs (i, i + 1).  Every rank of the axis calls it with a
    tensor of one shape and dtype."""
    n = axis_size(mesh, axis)
    i = mesh.get_local_rank(axis)
    if n == 1:
        return torch.zeros_like(x)
    group = mesh.get_group(axis)
    coord = list(mesh.get_coordinate())
    dim = mesh.mesh_dim_names.index(axis)

    def rank_at(k: int) -> int:
        coord[dim] = k
        return int(mesh.mesh[tuple(coord)])

    host = _through_host(group, x)
    send = x.cpu() if host else x.contiguous()
    recv = torch.empty_like(send)
    ops = []
    if i + 1 < n:
        ops.append(dist.P2POp(dist.isend, send, rank_at(i + 1), group))
    if i > 0:
        ops.append(dist.P2POp(dist.irecv, recv, rank_at(i - 1), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if i == 0:
        return torch.zeros_like(x)
    return recv.to(x.device) if host else recv


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (the default group when None), through
    a host buffer on gloo as :func:`shift_right`; ``x`` itself where no
    group is initialized."""
    if not dist.is_initialized():
        return x
    group = group if group is not None else dist.group.WORLD
    if _through_host(group, x):
        buf = x.cpu()
        dist.all_reduce(buf, group=group)
        return buf.to(x.device)
    buf = x.clone()
    dist.all_reduce(buf, group=group)
    return buf
