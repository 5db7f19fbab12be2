"""Time-sharded demodulation (sequence parallelism with halo exchange).

Counterpart of ``singlecarrier_tpu/parallel/timeshard.py``, on the XLA
path (``prod_rx_stream``, plain PyTorch, no kernel).  Splits one
channel's long PCM stream across ranks along the block axis.  The only
cross-block state in the signal chain (SURVEY.md section 2 SP row) is:

 * the FIR delay line: ntaps-1 = 48 samples (fir.c:30-34),
 * the hunt window: the previous block's 376 decimated symbols
   (qpsk.c:160-161),
 * the mixer phasor: closed-form, exp(j w N k) per block -- computable
   locally from the global block index with no communication.

So each shard needs a left halo of one raw PCM block plus 48 samples
(1928 samples): it receives it from its left neighbour on the mesh's
``time`` axis (``mesh.shift_right``), downmixes and filters it locally
to rebuild ``decim_prev`` and ``fir_tail``, and then runs its own
blocks: the overlap-save boundary design, one block of redundant
compute a shard for seam-free results.

Each function returns this rank's shard of what the JAX function
returns as a global sharded array; a caller that wants the whole array
gathers it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import ModemConfig
from ..constants import rrc_taps
from ..dsp.fir import fir_block
from ..dsp.mixer import mix_block
from ..modem.rx_production import ProdRxOut, ProdRxState, prod_rx_stream
from .mesh import axis_size, local_device, shift_right


def _block_phase(cfg: ModemConfig, block_idx: int, device) -> torch.Tensor:
    """Mixer phasor at the start of block ``block_idx`` (closed form).

    The per-block angle advance is reduced mod 2 pi in float64 on the
    host; only its product with the index, cast to float32 first as JAX
    casts it, is taken in float32: exp(j (w N mod 2 pi) k).
    """
    w = -2.0 * np.pi * cfg.center / cfg.fs
    adv = torch.tensor((w * cfg.frame_size) % (2.0 * np.pi),
                       dtype=torch.float32, device=device)
    ang = adv * torch.tensor(block_idx, dtype=torch.float32, device=device)
    return torch.exp(1j * ang).to(torch.complex64)


def _rebuild_boundary_state(cfg: ModemConfig, halo, my_first_block: int,
                            is_first: bool) -> ProdRxState:
    """The ProdRxState at this shard's first block from the 1928-sample
    left halo [..., frame_size + fir_halo] (the previous block and the
    48 samples before it)."""
    n_sym = cfg.symbols_per_block
    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    dev = halo.device
    if is_first:
        halo = torch.zeros_like(halo)
    x = halo.float() / cfg.tx_amplitude

    # downmix at the absolute phase of block my_first_block - 1, from 48
    # samples before its start
    phase0 = _block_phase(cfg, max(my_first_block - 1, 0), dev)
    w = (-2.0 * np.pi * cfg.center / cfg.fs) % (2.0 * np.pi)
    pre_rot = torch.exp(torch.tensor(-1j * w * cfg.fir_halo,
                                     dtype=torch.complex64, device=dev))
    raw, _ = mix_block(x, phase0 * pre_rot, -cfg.center, cfg.fs)

    # overlap-save: the halo's first 48 samples seed the FIR delay line,
    # the other frame_size filter into the previous block's symbols
    filtered, fir_tail = fir_block(taps, cfg.fir_gain,
                                   raw[..., :cfg.fir_halo],
                                   raw[..., cfg.fir_halo:])
    decim_prev = filtered.reshape(*filtered.shape[:-1], n_sym,
                                  cfg.cycles).transpose(-1, -2)
    if is_first:
        decim_prev = torch.zeros_like(decim_prev)
    lead = halo.shape[:-1]
    return ProdRxState(
        phase=_block_phase(cfg, my_first_block, dev).expand(lead).clone(),
        fir_tail=fir_tail.contiguous(),
        decim_prev=decim_prev.contiguous())


def _blocks_per_shard(n_blocks: int, n_dev: int) -> int:
    if n_blocks % n_dev or n_blocks // n_dev < 2:
        raise ValueError(f"n_blocks ({n_blocks}) must be a multiple of the "
                         f"mesh's time size ({n_dev}) with >= 2 blocks per "
                         f"shard")
    return n_blocks // n_dev


def time_sharded_rx(cfg: ModemConfig, pcm_blocks, mesh: DeviceMesh, *,
                    descramble: bool = True, axis: str = "time"):
    """Demodulate the global [n_blocks, frame_size] stream with the block
    axis sharded over the mesh's ``axis``: ``ProdRxOut`` of this rank's
    [n_blocks / size, ...] blocks."""
    n_dev = axis_size(mesh, axis)
    per = _blocks_per_shard(pcm_blocks.shape[0], n_dev)
    idx = mesh.get_local_rank(axis)
    local = pcm_blocks[idx * per:(idx + 1) * per].to(local_device(mesh))
    # the left halo: my last block and the 48 samples before it, sent to
    # the right neighbour
    sent = local.reshape(-1)[-(cfg.frame_size + cfg.fir_halo):]
    got = shift_right(sent.contiguous(), mesh, axis)
    state0 = _rebuild_boundary_state(cfg, got, idx * per, idx == 0)
    _, out = prod_rx_stream(cfg, state0, local, descramble=descramble)
    return out


def make_time_sharded_rx(cfg: ModemConfig, mesh: DeviceMesh, *,
                         descramble: bool = True, axis: str = "time"):
    return functools.partial(time_sharded_rx, cfg, mesh=mesh,
                             descramble=descramble, axis=axis)


def grid_sharded_rx(cfg: ModemConfig, pcm, mesh: DeviceMesh, *,
                    descramble: bool = True):
    """2D-sharded demodulation: channels on ``ch`` x blocks on ``time``.

    ``pcm``: the global [n_channels, n_blocks, frame_size]; n_channels a
    multiple of the mesh's ``ch`` size, n_blocks of its ``time`` size.
    Halos cross the ``time`` axis only; channels never communicate.
    Returns ``ProdRxOut`` of this rank's [n_channels / ch, n_blocks /
    time, ...] shard.
    """
    n_c, n_t = axis_size(mesh, "ch"), axis_size(mesh, "time")
    n_channels = pcm.shape[0]
    if n_channels % n_c:
        raise ValueError(f"channels ({n_channels}) not divisible by "
                         f"mesh['ch'] ({n_c})")
    per = _blocks_per_shard(pcm.shape[1], n_t)
    c_loc = n_channels // n_c
    idx = mesh.get_local_rank("time")
    i = mesh.get_local_rank("ch")
    local = pcm[i * c_loc:(i + 1) * c_loc, idx * per:(idx + 1) * per].to(
        local_device(mesh))
    flat = local.reshape(c_loc, -1)
    sent = flat[:, -(cfg.frame_size + cfg.fir_halo):].contiguous()
    got = shift_right(sent, mesh, "time")
    state0 = _rebuild_boundary_state(cfg, got, idx * per, idx == 0)
    _, out = prod_rx_stream(cfg, state0, local.transpose(0, 1),
                            descramble=descramble)
    return ProdRxOut(*(x.transpose(0, 1).contiguous() for x in out))


def make_grid_sharded_rx(cfg: ModemConfig, mesh: DeviceMesh, *,
                         descramble: bool = True):
    return functools.partial(grid_sharded_rx, cfg, mesh=mesh,
                             descramble=descramble)
