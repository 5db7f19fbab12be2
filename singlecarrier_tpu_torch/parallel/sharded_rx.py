"""Channel-sharded demodulation (the DP scaling axis).

Counterpart of ``singlecarrier_tpu/parallel/sharded_rx.py``.  Channels
are fully independent (the reference's per-channel state is a few KB of
statics -- SURVEY.md section 2 DP row), so scaling is pure data
parallelism: each rank runs the RX on its contiguous channel range, and
the demod path holds no cross-channel collective, only the optional
metric reduction (:func:`metrics_summary`).  The one exchange is the
time axis' halo (:func:`make_fused_grid_sharded_rx`).

Where the JAX function returns a global array sharded over the mesh,
its counterpart here returns this rank's shard; a caller that wants the
whole array gathers it (``torch.distributed.all_gather``).  The RX
functions take the PCM as the global array or as this rank's shard.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import ModemConfig
from ..dsp.mixer import tail_table
from ..modem.rx_production import (ProdRxOut, _plane_dtype,
                                   prod_rx_batch, prod_rx_stream)
from .mesh import all_reduce_sum, axis_size, local_device, shift_right


def channel_dims(state) -> tuple:
    """The channel axis of each leaf of a state: the plane tuple of
    ``prod_rx_init_planes`` (phase_r [C], phase_i [C], fir_tail_r [C,
    halo], fir_tail_i [C, halo], decim_prev_t [cyc, 2, C, n_sym]) holds
    it leading on the first four leaves and third on the transposed decim
    planes (``_plane_specs``); any other state leading on every leaf."""
    if (isinstance(state, tuple) and not hasattr(state, "_fields")
            and len(state) == 5
            and all(isinstance(t, torch.Tensor) for t in state)
            and state[4].dim() == 4):
        return (0, 0, 0, 0, 2)
    return (0,) * len(state)


def _rebuild(state, leaves):
    if hasattr(state, "_fields"):
        return type(state)(*leaves)
    return tuple(leaves)


def _shard(state, mesh: DeviceMesh, axis: str, dims):
    dev = local_device(mesh)
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)

    def take(x, d):
        C = x.shape[d]
        if C % n:
            raise ValueError(f"channels ({C}) not divisible by mesh "
                             f"'{axis}' size ({n})")
        return x.narrow(d, i * (C // n), C // n).to(dev).contiguous()
    return _rebuild(state, [take(x, d) for x, d in zip(state, dims)])


def shard_channel_state(state, mesh: DeviceMesh):
    """This rank's contiguous channel range of a batched state (every
    leaf's leading axis), on this rank's device.  The JAX function
    places the global state on the mesh; this returns its local shard."""
    return _shard(state, mesh, "ch", (0,) * len(state))


def shard_plane_state(planes, mesh: DeviceMesh, *, axis: str = "ch"):
    """This rank's contiguous channel range of a plane-tuple state
    (``prod_rx_init_planes``; the channel axis third on the decim
    planes), each leaf contiguous on this rank's device: the kernels
    take plain pointers.  Its local shard, where JAX places the state."""
    return _shard(planes, mesh, axis, channel_dims(tuple(planes)))


def _local_channels(pcm, c_local: int, mesh: DeviceMesh, axis: str,
                    dim: int):
    """This rank's channels of ``pcm`` along ``dim``: ``pcm`` itself when
    it holds ``c_local`` channels (this rank's shard), else its slice of
    the global array, contiguous."""
    C = pcm.shape[dim]
    if C == c_local:
        return pcm
    n = axis_size(mesh, axis)
    if C % n:
        raise ValueError(f"channels ({C}) not divisible by mesh '{axis}' "
                         f"size ({n})")
    if C // n != c_local:
        raise ValueError(f"{C} channels over mesh '{axis}' size {n} are "
                         f"not the state's {c_local} a rank")
    return pcm.narrow(dim, mesh.get_local_rank(axis) * c_local,
                      c_local).contiguous()


def make_channel_sharded_rx(cfg: ModemConfig, mesh: DeviceMesh, *,
                            descramble: bool = True):
    """``fn(state, pcm) -> (state, out)`` on the XLA path
    (``prod_rx_stream``, no kernel) over this rank's channels.

    ``state``: this rank's ``ProdRxState`` shard (``prod_rx_init(cfg,
    (n_channels,))`` + :func:`shard_channel_state`); ``pcm``: [channels,
    frames, frame_size] int16, the global array or this rank's shard.
    Returns this rank's state and its shard of the JAX function's output,
    [local channels, frames, ...] leaves (JAX's vmap layout).
    """
    def fn(state, pcm):
        pcm = _local_channels(pcm, state.phase.shape[0], mesh, "ch", 0)
        state, out = prod_rx_stream(cfg, state, pcm.transpose(0, 1),
                                    descramble=descramble)
        return state, ProdRxOut(*(x.transpose(0, 1).contiguous()
                                  for x in out))
    return fn


def make_fused_sharded_rx(cfg: ModemConfig, mesh: DeviceMesh, *,
                          descramble: bool = True, axis: str = "ch",
                          fuse_frontend: bool = True,
                          block_channels: int = 128,
                          decode_block_channels: int | None = None,
                          interpret: bool = False):
    """The main path's kernels on this rank's channel shard.

    ``fn(planes, pcm) -> (planes, ProdRxOut)`` runs ``prod_rx_batch``
    (``fuse_frontend=True``: the three kernels of the one-kernel path,
    K1 ``frontend_decim``, K2 ``hunt``, K3 ``extract_decode``; ``False``:
    the per-row front-end then the hunt and decode) on [B, C/n,
    frame_size].  ``planes``: this rank's plane-state shard
    (``prod_rx_init_planes`` + :func:`shard_plane_state`); ``pcm``: [B,
    C, frame_size] int16, the global array (``ValueError`` where C is not
    a multiple of the mesh's ``axis`` size) or this rank's shard.
    Channels are independent, so the program holds no collective; it
    returns this rank's state and its shard of the JAX function's output,
    [B, C/n, ...] leaves.  ``block_channels``,
    ``decode_block_channels`` and ``interpret`` size the TPU kernels:
    accepted and ignored, as ``prod_rx_batch`` does.
    """
    def fn(planes, pcm):
        pcm = _local_channels(pcm, planes[0].shape[0], mesh, axis, 1)
        return prod_rx_batch(cfg, planes, pcm, descramble=descramble,
                             fuse_frontend=fuse_frontend)
    return fn


def _grid_shard(cfg: ModemConfig, pcm_local, in_blk, in_pre, t_idx: int,
                n_t: int, *, descramble: bool = True,
                fuse_frontend: bool = True) -> ProdRxOut:
    """One shard of :func:`make_fused_grid_sharded_rx`: the outputs of
    its ``B_loc`` blocks [B_loc, C_loc, ...].

    ``pcm_local`` [B_loc, C_loc, frame_size] are the blocks of time shard
    ``t_idx`` of ``n_t``; ``in_blk`` [C_loc, frame_size] and ``in_pre``
    [C_loc, ntaps - 1] the left neighbour's last block and the raw
    samples before it (ignored, as zeros, on shard 0).  The halo block
    goes in front with closed-form carries: the mixer phase entering it,
    adv^(g - 1) at global block g, from a float64 table by shard; the FIR
    tail entering it, the downmixed tail of block g - 1, rebuilt in f32
    with the JAX package's products (``sharded_rx.py:193-214``); zero
    decim planes, which reach only the halo block's own hunt window.  Its
    outputs are dropped.
    """
    B_loc, C_loc = pcm_local.shape[0], pcm_local.shape[1]
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    dev = pcm_local.device
    if t_idx == 0:
        in_blk = torch.zeros_like(in_blk)
        in_pre = torch.zeros_like(in_pre)
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    g_tab = np.arange(n_t, dtype=np.float64) * B_loc - 1.0
    ph1 = np.exp(1j * w_ * n * g_tab).astype(np.complex64)[t_idx]
    ph2 = np.exp(1j * w_ * n * (g_tab - 1.0)).astype(np.complex64)[t_idx]
    f32 = dict(dtype=torch.float32, device=dev)
    p_r = torch.full((C_loc,), float(ph1.real), **f32)
    p_i = torch.full((C_loc,), float(ph1.imag), **f32)
    # FIR tail entering g: the downmixed tail of block g - 1 at phase(g - 1)
    qr, qi = float(ph2.real), float(ph2.imag)
    tr_t, ti_t = tail_table(cfg.center, cfg.fs, n, halo, dev)
    x_t = in_pre.to(dev).float() * (1.0 / cfg.tx_amplitude)
    tl_r = x_t * (qr * tr_t - qi * ti_t)
    tl_i = x_t * (qr * ti_t + qi * tr_t)
    planes = (p_r, p_i, tl_r, tl_i,
              torch.zeros((cfg.cycles, 2, C_loc, cfg.symbols_per_block),
                          dtype=_plane_dtype(cfg), device=dev))
    pcm_ext = torch.cat([in_blk.to(dev, pcm_local.dtype)[None], pcm_local])
    _, out = prod_rx_batch(cfg, planes, pcm_ext, descramble=descramble,
                           fuse_frontend=fuse_frontend)
    return ProdRxOut(*(x[1:] for x in out))


def make_fused_grid_sharded_rx(cfg: ModemConfig, mesh: DeviceMesh, *,
                               descramble: bool = True,
                               fuse_frontend: bool = True,
                               decode_block_channels: int | None = None,
                               interpret: bool = False):
    """The main path's kernels on a ``(ch, time)`` grid (one-shot).

    ``fn(pcm) -> ProdRxOut``: ``pcm`` is the global [n_blocks,
    n_channels, frame_size] int16 (n_blocks a multiple of the mesh's
    ``time`` size with at least 2 blocks a shard, n_channels of its
    ``ch`` size, else ``ValueError``).  Channels shard as pure DP; the
    time axis shards the blocks with a one-block overlap-save halo: each
    rank sends its last block and the ``ntaps - 1`` samples before it to
    its right neighbour on ``time`` (:func:`..mesh.shift_right`; shard 0
    receives zeros) and runs :func:`_grid_shard`.  Returns this rank's
    shard of the JAX function's output, [n_blocks / time, n_channels /
    ch, ...] leaves.  Decisions equal the unsharded path's across both
    seam kinds; the float statistics at a seam may differ in the last
    ulps (the carried FIR tail is rebuilt in f32).
    ``decode_block_channels`` and ``interpret``: accepted and ignored.
    """
    n_t, n_c = axis_size(mesh, "time"), axis_size(mesh, "ch")
    halo = cfg.ntaps - 1
    n = cfg.frame_size

    def fn(pcm):
        B, C = pcm.shape[0], pcm.shape[1]
        if B % n_t or B // n_t < 2:
            raise ValueError(
                f"n_blocks ({B}) must be a multiple of mesh['time'] "
                f"({n_t}) with >= 2 blocks per shard")
        if C % n_c:
            raise ValueError(
                f"channels ({C}) not divisible by mesh['ch'] ({n_c})")
        b_loc, c_loc = B // n_t, C // n_c
        t = mesh.get_local_rank("time")
        i = mesh.get_local_rank("ch")
        local = pcm[t * b_loc:(t + 1) * b_loc,
                    i * c_loc:(i + 1) * c_loc].to(
                        local_device(mesh)).contiguous()
        sent = torch.cat([local[-2, :, n - halo:], local[-1]], dim=-1)
        got = shift_right(sent, mesh, "time")
        return _grid_shard(cfg, local, got[:, halo:], got[:, :halo], t, n_t,
                           descramble=descramble,
                           fuse_frontend=fuse_frontend)
    return fn


def metrics_summary(out: ProdRxOut, group=None) -> dict:
    """Cross-channel metric reduction: packets detected, mean CFO and
    mean eq error over the valid blocks of every rank's shard of ``out``.
    One ``all_reduce(SUM)`` over ``group`` (the mesh's ``ch`` group,
    ``mesh.get_group("ch")``; the default group when None; none without
    an initialized group) of the detected count and the two masked sums,
    in float64, then divided as the JAX function divides.  Returns 0-d
    tensors: the count as int64, the means as float64."""
    v = out.valid
    zero = torch.zeros((), dtype=out.cfo_hz.dtype, device=v.device)
    sums = torch.stack([v.sum().double(),
                        torch.where(v, out.cfo_hz, zero).double().sum(),
                        torch.where(v, out.eq_error, zero).double().sum()])
    sums = all_reduce_sum(sums, group)
    det = sums[0]
    safe = torch.where(det > 0, det, torch.ones_like(det))
    return {
        "packets_detected": det.to(torch.int64),
        "mean_cfo_hz": torch.where(det > 0, sums[1] / safe,
                                   torch.zeros_like(det)),
        "mean_eq_error": torch.where(det > 0, sums[2] / safe,
                                     torch.zeros_like(det)),
    }
