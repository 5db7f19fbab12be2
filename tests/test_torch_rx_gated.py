"""PyTorch port, the detection-gated two-phase RX vs JAX.

The four cases of the JAX package's own tests (tests/test_gated_rx.py:
single dispatch, a block-0 detection across the dispatch seam, a channel
count that is no multiple of 128, capacity truncation) run through
``singlecarrier_tpu.modem.prod_rx_batch_gated`` (interpret mode) and the
port's, on the same int16 frames.  The compaction is part of the
output: ``count``, ``block_idx`` and ``channel_idx`` must be identical
(a stable sort of the gate flags), and the compacted rows are held to
the ROADMAP criterion (identical valid, bits on valid rows, matches, lag
and phase; |dcfo| < 0.5 Hz, |deq_error| < 2e-3).  The gate stage's
columns (``stage="gate"``) are compared with JAX's: gated flags equal,
energy to 1e-5 relative (a 128-term f32 sum in another order), lag,
phase and peak on gated rows, every decode slot zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import prod_rx_batch_gated as jax_gated
from singlecarrier_tpu.modem import prod_rx_gated_init as jax_gated_init
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.ops.fused_rx import fused_rx_block as jax_rx_block
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (prod_rx_batch,
                                           prod_rx_batch_gated,
                                           prod_rx_gated_init,
                                           prod_rx_init_planes)
from singlecarrier_tpu_torch.ops.decode import fused_hunt_decode_decim
from singlecarrier_tpu_torch.ops.fused_rx import fused_rx_block

TCFG = interop.config_from_dict(dataclasses.asdict(CFG))
C = 4


def _stream(n_packets=3, seed=71):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_packets, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    n = -(-len(pcm) // CFG.frame_size) + 1
    buf = np.zeros(n * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    frames = buf.reshape(n, CFG.frame_size)
    return np.broadcast_to(frames[:, None, :],
                           (n, C, CFG.frame_size)).copy()


def _np_state(st_j):
    return (tuple(np.asarray(a) for a in st_j.planes),
            np.asarray(st_j.pcm_prev), np.asarray(st_j.pcm_prev2_tail))


def _both(st_j, batch, K):
    """One dispatch through both packages, the port starting from the
    JAX state before it."""
    st_t = interop.gated_state_from_numpy(_np_state(st_j), device="cpu")
    st_j, o_j = jax_gated(CFG, st_j, jnp.asarray(batch), max_detections=K,
                          block_channels=C, descramble=False,
                          interpret=True)
    st_t, o_t = prod_rx_batch_gated(TCFG, st_t, torch.from_numpy(batch),
                                    max_detections=K, block_channels=C,
                                    descramble=False, interpret=True)
    return st_j, st_t, jax.tree.map(np.asarray, o_j), o_t


def _assert_gated_parity(o_t, o_j):
    assert int(o_t["count"]) == int(o_j["count"])
    for k in ("block_idx", "channel_idx", "valid"):
        assert np.array_equal(o_t[k].numpy(), o_j[k]), k
    assert o_t["block_idx"].dtype == o_t["channel_idx"].dtype == torch.int32
    v = o_j["valid"]
    for k in ("bits", "dibits", "matches", "lag", "timing_phase"):
        assert np.array_equal(o_t[k].numpy()[v], o_j[k][v]), k
    if v.any():
        assert np.abs(o_t["cfo_hz"].numpy()[v] - o_j["cfo_hz"][v]).max() < 0.5
        assert np.abs(o_t["eq_error"].numpy()[v]
                      - o_j["eq_error"][v]).max() < 2e-3


def _assert_state_parity(st_t, st_j):
    pl_t, prev_t, tail_t = interop.gated_state_to_numpy(st_t)
    pl_j, prev_j, tail_j = _np_state(st_j)
    assert np.array_equal(prev_t, prev_j) and prev_t.dtype == np.int16
    assert np.array_equal(tail_t, tail_j) and tail_t.dtype == np.int16
    for a, b in zip(pl_t[:4], pl_j[:4]):
        assert np.abs(a - b).max() <= 1e-6
    assert np.abs(pl_t[4] - pl_j[4]).max() < 2e-5       # f32 planes


def _rows_equal_full_path(o_g, full, b_off=0):
    """Every valid gated row equals the port's full-path decision at
    its (block_idx, channel_idx)."""
    rows = 0
    for i in torch.nonzero(o_g["valid"])[:, 0]:
        b = int(o_g["block_idx"][i]) + b_off
        c = int(o_g["channel_idx"][i])
        assert bool(full.valid[b, c])
        assert torch.equal(o_g["bits"][i], full.bits[b, c])
        assert int(o_g["matches"][i]) == int(full.matches[b, c])
        assert int(o_g["lag"][i]) == int(full.lag[b, c])
        assert int(o_g["timing_phase"][i]) == int(full.timing_phase[b, c])
        rows += 1
    return rows


def _full(batch):
    return prod_rx_batch(TCFG, prod_rx_init_planes(TCFG, C, "cpu"),
                         torch.from_numpy(batch), descramble=False,
                         fuse_frontend=True)[1]


def test_gated_rx_single_dispatch_matches_jax_and_the_full_path():
    batch = _stream()
    full = _full(batch)
    n_valid = int(full.valid.sum())
    st_j, st_t, o_j, o_t = _both(jax_gated_init(CFG, C), batch, 2 * n_valid)
    _assert_gated_parity(o_t, o_j)
    _assert_state_parity(st_t, st_j)
    # the energy gate alone fires on more blocks than the final criterion
    assert n_valid <= int(o_t["count"]) <= 2 * n_valid
    assert int(o_t["valid"].sum()) == n_valid == 3 * C
    assert _rows_equal_full_path(o_t, full) == n_valid
    assert tuple(o_t["bits"].shape) == (2 * n_valid, CFG.bits_per_frame)


def test_gated_rx_block0_detection_across_the_dispatch_seam():
    batch = _stream()
    full = _full(batch)
    vb = torch.nonzero(full.valid[:, 0])[:, 0]
    split = int(vb[1])          # a detection block becomes block 0
    assert split >= 2
    st_j = jax_gated_init(CFG, C)
    st_j, st_t, o_j, out_a = _both(st_j, batch[:split], 16)
    _assert_gated_parity(out_a, o_j)
    _assert_state_parity(st_t, st_j)
    st_j, st_t, o_j, out_b = _both(st_j, batch[split:], 16)
    _assert_gated_parity(out_b, o_j)
    _assert_state_parity(st_t, st_j)
    got = (_rows_equal_full_path(out_a, full)
           + _rows_equal_full_path(out_b, full, b_off=split))
    assert got == int(full.valid.sum())
    assert bool((out_b["valid"] & (out_b["block_idx"] == 0)).any())


def test_gated_rx_chains_its_own_state_across_the_seam():
    """The port alone, its own state carried (no JAX state in between),
    B = 1 dispatches included (``pcm_prev2_tail`` from ``pcm_prev``)."""
    batch = _stream()
    full = _full(batch)
    st = prod_rx_gated_init(TCFG, C, device="cpu")
    got = 0
    for b in range(batch.shape[0]):
        st, out = prod_rx_batch_gated(TCFG, st, torch.from_numpy(batch[b:b + 1]),
                                      max_detections=8, descramble=False)
        got += _rows_equal_full_path(out, full, b_off=b)
    assert got == int(full.valid.sum())


def test_gated_rx_channel_counts_and_capacities_that_divide_nothing():
    """C = 192 (no multiple of 128) with K = 12, and a capacity above
    the dispatch size (the order is padded with row 0)."""
    C2, B, K = 192, 2, 12
    st = prod_rx_gated_init(TCFG, C2, device="cpu")
    pcm = torch.zeros((B, C2, CFG.frame_size), dtype=torch.int16)
    st, out = prod_rx_batch_gated(TCFG, st, pcm, max_detections=K,
                                  block_channels=7)
    assert tuple(out["dibits"].shape) == (K, CFG.frame_symbols)
    assert int(out["count"]) == 0 and not bool(out["valid"].any())
    st = prod_rx_gated_init(TCFG, C, device="cpu")
    batch = _stream()[:1]
    _, out = prod_rx_batch_gated(TCFG, st, torch.from_numpy(batch),
                                 max_detections=2 * C, descramble=False)
    assert tuple(out["valid"].shape) == (2 * C,)
    assert out["block_idx"][C:].tolist() == [0] * C


def test_gated_rx_capacity_truncation_reported():
    batch = _stream()
    _, _, o_j, o_t = _both(jax_gated_init(CFG, C), batch, 2)
    _assert_gated_parity(o_t, o_j)
    assert int(o_t["count"]) > 2                 # truncation is visible
    assert int(o_t["valid"].sum()) <= 2


def test_gate_stage_columns_match_jax():
    batch = _stream()
    st_j = jax_gated_init(CFG, C).planes
    dec_j, dlast_j, _ = jax_rx_block(CFG, jnp.asarray(batch), *st_j,
                                     stage="gate", descramble=False,
                                     block_channels=C, interpret=True)
    dec_j = jax.tree.map(np.asarray, dec_j)
    st_t = interop.planes_from_numpy([np.asarray(a) for a in st_j],
                                     device="cpu")
    dec_t, dlast_t, _ = fused_rx_block(TCFG, torch.from_numpy(batch), *st_t,
                                       stage="gate", descramble=False)
    g = dec_j["gated"]
    assert g.any() and not g.all()
    assert np.array_equal(dec_t["gated"].numpy(), g)
    assert np.allclose(dec_t["energy"].numpy(), dec_j["energy"], rtol=1e-5,
                       atol=1e-12)
    for k in ("lag", "phase_idx"):
        assert np.array_equal(dec_t[k].numpy()[g], dec_j[k][g]), k
    assert np.allclose(dec_t["peak"].numpy()[g], dec_j["peak"][g], rtol=1e-5)
    for k in ("dibits", "matches", "eq_error", "cfo_hz"):
        assert not dec_t[k].any() and not dec_j[k].any(), k
    assert np.abs(dlast_t.numpy() - np.asarray(dlast_j)).max() < 2e-5
    # the gate flags are the full stage's
    full_t, _, _ = fused_rx_block(TCFG, torch.from_numpy(batch), *st_t,
                                  descramble=False)
    assert torch.equal(full_t["gated"], dec_t["gated"])
    assert torch.equal(full_t["energy"], dec_t["energy"])


def test_probe_stages_are_not_ported():
    planes = prod_rx_init_planes(TCFG, C, "cpu")
    with pytest.raises(NotImplementedError, match="stage"):
        fused_hunt_decode_decim(TCFG, planes[4], planes[4], channels=C,
                                stage="hunt")
    with pytest.raises(NotImplementedError, match="stage"):
        fused_rx_block(TCFG, torch.zeros((1, C, CFG.frame_size),
                                         dtype=torch.int16),
                       *planes, stage="extract")
