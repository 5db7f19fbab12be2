"""Checkpoint / resume of demodulator state.

Counterpart of ``singlecarrier_tpu/runtime/checkpoint.py``'s
``save_state`` / ``restore_state``.  The reference has no persistence at
all -- its state dies with the process (static globals, SURVEY.md
section 5).  Here the per-channel state is an explicit structure of
tensors, so checkpointing between streaming blocks is exact by
construction: save it, restore it, continue -- bit-identical resume.

The states the port's entry points carry are covered: ``ProdRxState``,
the plane 5-tuple of ``prod_rx_init_planes`` (bf16 planes stay bf16),
``GatedRxState`` and the faithful ``RxState``; any nesting of tuples,
lists and NamedTuples of tensors is.  The file is one ``torch.save`` of
plain dicts, lists, strings, ints and CPU tensors, so it loads under
``torch.load(weights_only=True)``: a NamedTuple is stored as its type's
name and its field names, and a complex tensor as its real and
imaginary planes (the JAX package's on-disk layout).  The write goes to
a temporary file that is renamed over the target, so a reader sees the
old checkpoint or the new one, never half of one.

``save_sharded`` / ``restore_sharded`` are the path for a state sharded
over ranks (``parallel.shard_channel_state`` / ``shard_plane_state``):
a ``torch.distributed.checkpoint`` save in which every rank writes only
its own shard and reads only its own back, the state never gathered to
one process.
"""

from __future__ import annotations

import os
import threading
from typing import Any

import torch

from ..device import resolve_device
from ..modem.rx import RxState
from ..modem.rx_gated import GatedRxState
from ..modem.rx_production import ProdRxState

# the NamedTuple kinds a checkpoint names, for a restore without ``like``
_KINDS = {cls.__name__: cls for cls in (ProdRxState, GatedRxState, RxState)}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A compact CPU copy of ``t`` (a view's base is not saved)."""
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")
    return out.copy_(t.detach())


def _encode(x) -> dict:
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return {"leaf": "complex", "re": _to_host(x.real),
                    "im": _to_host(x.imag)}
        return {"leaf": "tensor", "value": _to_host(x)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"node": "namedtuple", "type": type(x).__name__,
                "fields": list(x._fields),
                "children": [_encode(c) for c in x]}
    if isinstance(x, (tuple, list)):
        return {"node": type(x).__name__,
                "children": [_encode(c) for c in x]}
    raise TypeError(f"cannot checkpoint a {type(x).__name__} leaf")


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"tensor {x.dtype} {tuple(x.shape)}"
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return f"{type(x).__name__}{tuple(x._fields)}"
    return f"{type(x).__name__} of {len(x)}"


def _decode(enc: dict, like, device, path: str):
    """Rebuild ``enc`` on ``like``'s structure and device (or on
    ``device`` when ``like`` is None); ValueError where they differ."""
    def mismatch(what: str):
        return ValueError(f"checkpoint structure at state{path}: {what}, "
                          f"expected {_describe(like)}")

    if "leaf" in enc:
        if enc["leaf"] == "complex":
            value = torch.complex(enc["re"], enc["im"])
        else:
            value = enc["value"]
        if like is not None:
            if not (isinstance(like, torch.Tensor)
                    and like.dtype == value.dtype
                    and like.shape == value.shape):
                raise mismatch(_describe(value))
            device = like.device
        return value.to(device)

    children = enc["children"]
    if enc["node"] == "namedtuple":
        fields = tuple(enc["fields"])
        if like is None:
            cls = _KINDS.get(enc["type"])
            if cls is None:
                raise ValueError(f"checkpoint holds a {enc['type']}: pass "
                                 f"`like` to restore it")
        elif (isinstance(like, tuple) and hasattr(like, "_fields")
              and type(like).__name__ == enc["type"]
              and tuple(like._fields) == fields):
            cls = type(like)
        else:
            raise mismatch(f"{enc['type']}{fields}")
        return cls(*(_decode(c, None if like is None else getattr(like, f),
                             device, f"{path}.{f}")
                     for f, c in zip(fields, children)))
    cls = tuple if enc["node"] == "tuple" else list
    if like is not None and not (type(like) is cls
                                 and len(like) == len(children)):
        raise mismatch(f"{enc['node']} of {len(children)}")
    return cls(_decode(c, None if like is None else like[i], device,
                       f"{path}[{i}]")
               for i, c in enumerate(children))


def save_state(path: str, state: Any, *, step: int = 0) -> None:
    """Persist a demod state (+ stream position) to one file, atomically.

    Copies every leaf to this host once.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"step": int(step), "state": _encode(state)}
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_state(path: str, like: Any = None, *, device=None):
    """Load ``(state, step)``.

    ``like`` (optional) is a state of the expected structure: its
    NamedTuple kinds and fields, tuple lengths and each leaf's dtype and
    shape must match the file's, else ``ValueError``; the state is
    restored onto ``like``'s device.  Without ``like`` it goes to
    ``device`` (the card unless that says otherwise).
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    dev = None if like is not None else resolve_device(device)
    return _decode(payload["state"], like, dev, ""), payload["step"]


# ---------------------------------------------------------------------------
# Sharded path (torch.distributed.checkpoint)


def _leaf_names(state):
    return (state._fields if hasattr(state, "_fields")
            else [str(i) for i in range(len(state))])


def _sharded_leaves(state):
    """(key, local tensor, channel axis) of a flat state (a NamedTuple or
    tuple of tensors); a complex leaf as its real and imaginary planes
    (the JAX package's {re, im})."""
    from ..parallel.sharded_rx import channel_dims
    for name, x, d in zip(_leaf_names(state), state, channel_dims(state)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"cannot checkpoint a {type(x).__name__} leaf")
        if x.is_complex():
            yield f"state.{name}.re", x.real, d
            yield f"state.{name}.im", x.imag, d
        else:
            yield f"state.{name}", x, d


def _channel_mesh(state, mesh):
    """``mesh``, or the default group's ranks on one ``ch`` axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None:
        return mesh
    if not dist.is_initialized():
        raise ValueError("save_sharded / restore_sharded need an "
                         "initialized process group (parallel.make_mesh "
                         "makes a one-rank one)")
    return DeviceMesh(state[0].device.type,
                      torch.arange(dist.get_world_size()),
                      mesh_dim_names=("ch",))


def _dtensors(state, mesh, fill):
    """{key: DTensor} over ``mesh``, each leaf sharded on its channel
    axis along the mesh's ``ch`` dimension and replicated along any
    other; ``fill(local)`` gives the local tensor wrapped."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out = {}
    for key, x, d in _sharded_leaves(state):
        placements = [Shard(d) if name == "ch" else Replicate()
                      for name in mesh.mesh_dim_names]
        out[key] = DTensor.from_local(fill(x), mesh, placements,
                                      run_check=False)
    return out


def save_sharded(path: str, state: Any, *, step: int = 0,
                 mesh=None) -> None:
    """Save a channel-sharded state: every rank passes its own shard and
    writes only it (``torch.distributed.checkpoint``).

    ``state``: this rank's ``ProdRxState`` or plane tuple (bf16 planes
    stay bf16).  ``mesh``: the mesh it is sharded on (a ``DeviceMesh``
    with a ``ch`` dimension); default, the default group's ranks in
    order on one ``ch`` axis, as ``shard_*_state`` on ``make_mesh()``
    leaves them.  Every rank calls it with the same ``path``.
    """
    import torch.distributed.checkpoint as dcp
    mesh = _channel_mesh(state, mesh)
    sd = _dtensors(state, mesh, lambda x: x.contiguous())
    sd["step"] = torch.tensor(int(step), dtype=torch.int64)
    dcp.save(sd, checkpoint_id=os.path.abspath(path))


def restore_sharded(path: str, like: Any, *, mesh=None):
    """Restore ``(state, step)`` saved by :func:`save_sharded` onto the
    same mesh: every rank reads only its own shard, onto ``like``'s
    devices.  ``like`` is this rank's shard of a state of the expected
    structure; a leaf whose global shape or dtype differs from the
    checkpoint's, or a structure that does, raises ``ValueError``."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    mesh = _channel_mesh(like, mesh)
    sd = _dtensors(like, mesh, torch.empty_like)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if set(saved) != set(sd) | {"step"}:
        raise ValueError(f"checkpoint structure {sorted(saved)}, expected "
                         f"{sorted(set(sd) | {'step'})}")
    for key, t in sd.items():
        meta = saved[key]
        if (tuple(meta.size) != tuple(t.shape)
                or meta.properties.dtype != t.dtype):
            raise ValueError(
                f"checkpoint structure at {key}: tensor "
                f"{meta.properties.dtype} {tuple(meta.size)}, expected "
                f"tensor {t.dtype} {tuple(t.shape)}")
    sd["step"] = torch.zeros((), dtype=torch.int64)
    dcp.load(sd, checkpoint_id=path)

    from ..parallel.sharded_rx import _rebuild
    leaves = []
    for name, x in zip(_leaf_names(like), like):
        key = f"state.{name}"
        if x.is_complex():
            leaves.append(torch.complex(sd[key + ".re"].to_local(),
                                        sd[key + ".im"].to_local()))
        else:
            leaves.append(sd[key].to_local())
    return _rebuild(like, leaves), int(sd["step"])
