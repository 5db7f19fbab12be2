"""Carry configs and RX state across the two packages.

The system has no weights; what crosses between the JAX package and the
port is a ``ModemConfig`` (as ``dataclasses.asdict``: the two classes
are different types with the same fields) and the RX state, as numpy
arrays: the plane state of ``prod_rx_init_planes`` (``(phase_r,
phase_i, fir_tail_r, fir_tail_i, decim_prev_t)``, where
``decim_prev_t`` may be ``ml_dtypes.bfloat16``) or the complex
``ProdRxState`` (phase c64 [C], fir_tail c64 [C, ntaps-1], decim_prev
c64 [C, cycles, n_sym]) or the ``GatedRxState`` (the plane state plus
two int16 PCM leaves) or the faithful path's ``RxState`` (four complex64
and three int32 leaves).  ``torch.from_numpy`` refuses bf16, so bf16
crosses as its raw 16-bit pattern.  Tensors are made on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModemConfig
from .device import resolve_device
from .modem.rx import RxState
from .modem.rx_gated import GatedRxState
from .modem.rx_production import ProdRxState


def config_from_dict(fields: dict) -> ModemConfig:
    """The port's ``ModemConfig`` from ``dataclasses.asdict`` of the JAX
    package's (or of its own)."""
    return ModemConfig(**fields)


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def planes_from_numpy(planes, device=None):
    """JAX plane state (numpy arrays) -> tuple of torch tensors."""
    dev = resolve_device(device)
    return tuple(_to_torch(np.asarray(a), dev) for a in planes)


def planes_to_numpy(planes):
    """Torch plane state -> tuple of numpy arrays (bf16 as
    ``ml_dtypes.bfloat16``, the JAX package's host type)."""
    return tuple(_to_numpy(t) for t in planes)


def state_from_numpy(state, device=None) -> ProdRxState:
    """JAX ``ProdRxState`` leaves (complex64 numpy arrays, in field
    order) -> the port's ``ProdRxState``."""
    dev = resolve_device(device)
    return ProdRxState(*(_to_torch(np.asarray(a, np.complex64), dev)
                         for a in state))


def state_to_numpy(state: ProdRxState):
    """The port's ``ProdRxState`` -> tuple of complex64 numpy arrays."""
    return tuple(_to_numpy(t) for t in state)


def gated_state_from_numpy(state, device=None) -> GatedRxState:
    """JAX ``GatedRxState`` leaves as numpy arrays (``(planes, pcm_prev,
    pcm_prev2_tail)``) -> the port's ``GatedRxState``."""
    planes, pcm_prev, pcm_prev2_tail = state
    dev = resolve_device(device)
    return GatedRxState(
        planes=planes_from_numpy(planes, dev),
        pcm_prev=_to_torch(np.asarray(pcm_prev, np.int16), dev),
        pcm_prev2_tail=_to_torch(np.asarray(pcm_prev2_tail, np.int16), dev))


def gated_state_to_numpy(state: GatedRxState):
    """The port's ``GatedRxState`` -> ``(planes, pcm_prev,
    pcm_prev2_tail)`` of numpy arrays."""
    return (planes_to_numpy(state.planes), _to_numpy(state.pcm_prev),
            _to_numpy(state.pcm_prev2_tail))


_RX_DTYPES = (np.complex64,) * 4 + (np.int32,) * 3   # RxState's leaves


def rx_state_from_numpy(state, device=None) -> RxState:
    """JAX ``RxState`` leaves (numpy arrays, in field order: phase,
    fir_tail, raw_prev, decim_prev complex64; rx_timing,
    scramble_offset, sm_state int32) -> the port's ``RxState``."""
    dev = resolve_device(device)
    return RxState(*(_to_torch(np.asarray(a, dt), dev)
                     for a, dt in zip(state, _RX_DTYPES)))


def rx_state_to_numpy(state: RxState):
    """The port's ``RxState`` -> tuple of numpy arrays in field order."""
    return tuple(_to_numpy(t) for t in state)
