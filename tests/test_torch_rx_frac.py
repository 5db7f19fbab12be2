"""PyTorch port, the fractional-timing streaming RX vs JAX.

``prod_rx_stream_pallas`` with ``cfg.frac_timing`` (the full-rate
front-end, TPU kernel ``frontend_pallas._kernel``; the plain hunt with
its parabolic sub-sample offset; the blended extraction;
``fused_decode``) on fractionally delayed streams, as the JAX package's
own test delays them (tests/test_rx_production.py), against the JAX
function in interpret mode.  Held to the ROADMAP criterion: identical
valid, bits on valid rows, lag and phase on detected rows, |dcfo| <
0.5 Hz, |deq_error| < 2e-3; the carried complex state to 1e-6.  The
hunt and the extraction are also compared alone on the same windows:
``frac`` to 1e-3 on rows that hold a preamble (on noise rows the
parabola divides ~0 by ~0), packets to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.channel import fractional_delay
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (prod_rx_init,
                                           prod_rx_stream_pallas)
from singlecarrier_tpu_torch.modem import rx_production as trx

FRAC = CFG.replace(frac_timing=True)
DELAYS = (0.4, -0.3, 0.0, 0.25)     # samples, one per channel
SHIFTS = (0, 377, 1203, 1878)       # whole samples, one per channel
C = len(DELAYS)


def _frames(seed=11, n_packets=3):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_packets, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, jnp.asarray(bits), flush_gap=True)
    n = CFG.frame_size
    nb = -(-(len(pcm) + max(SHIFTS)) // n) + 1
    x = np.zeros((C, nb * n), np.int16)
    for c, (d, s) in enumerate(zip(DELAYS, SHIFTS)):
        y = np.asarray(fractional_delay(pcm.astype(jnp.float32), d))
        x[c, s:s + len(y)] = y.astype(np.int16)
    return x.reshape(C, nb, n).transpose(1, 0, 2).copy(), bits


def _run_jax(cfg, frames):
    st, out = jrx.prod_rx_stream_pallas(
        cfg, jrx.prod_rx_init(cfg, (C,)), jnp.asarray(frames),
        descramble=False, block_channels=C, decode_block_channels=C,
        interpret=True)
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("cfg", [FRAC, FRAC.replace(hunt_dtype="int8")],
                         ids=["default", "int8-hunt"])
def test_frac_stream_matches_jax_and_decodes(cfg):
    frames, bits = _frames()
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    st_j, o_j = _run_jax(cfg, frames)
    st_t, o_t = prod_rx_stream_pallas(
        tcfg, prod_rx_init(tcfg, (C,), device="cpu"),
        torch.from_numpy(frames), descramble=False)
    v = o_j.valid
    assert np.array_equal(o_t.valid.numpy(), v)
    assert np.array_equal(o_t.bits.numpy()[v], o_j.bits[v])
    assert np.array_equal(o_t.lag.numpy()[v], o_j.lag[v])
    assert np.array_equal(o_t.timing_phase.numpy()[v], o_j.timing_phase[v])
    assert np.array_equal(o_t.matches.numpy()[v], o_j.matches[v])
    assert np.abs(o_t.cfo_hz.numpy()[v] - o_j.cfo_hz[v]).max() < 0.5
    assert np.abs(o_t.eq_error.numpy()[v] - o_j.eq_error[v]).max() < 2e-3
    sent = bits.reshape(-1, CFG.bits_per_frame)
    for c in range(C):
        assert np.array_equal(o_t.bits.numpy()[:, c][v[:, c]], sent)
    for a, b in zip(interop.state_to_numpy(st_t), st_j):
        assert a.dtype == np.complex64 and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6


def test_frac_stream_splits_across_calls():
    """Two calls carrying the ProdRxState equal one call."""
    frames, _ = _frames(seed=12)
    tcfg = interop.config_from_dict(dataclasses.asdict(FRAC))
    x = torch.from_numpy(frames)
    st0 = prod_rx_init(tcfg, (C,), device="cpu")
    st_one, one = prod_rx_stream_pallas(tcfg, st0, x, descramble=False)
    st, a = prod_rx_stream_pallas(tcfg, st0, x[:3], descramble=False)
    st, b = prod_rx_stream_pallas(tcfg, st, x[3:], descramble=False)
    for p, q, r in zip(one, a, b):
        assert torch.equal(p, torch.cat([q, r]))
    for p, q in zip(st_one, st):
        assert torch.equal(p, q)
    assert int(one.valid.sum()) == 3 * C


def _windows(frames):
    """Complex hunt windows [nb-1, C, cyc, 2*n_sym] of consecutive block
    pairs, from the port's full-rate front-end."""
    tcfg = interop.config_from_dict(dataclasses.asdict(FRAC))
    st = prod_rx_init(tcfg, (C,), device="cpu")
    blocks = []
    for blk in torch.from_numpy(frames):
        st, _ = prod_rx_stream_pallas(tcfg, st, blk[None], descramble=False)
        blocks.append(st.decim_prev)
    return torch.stack([torch.cat([p, q], -1)
                        for p, q in zip(blocks[:-1], blocks[1:])]).numpy()


def test_hunt_and_blended_extraction_match_jax_on_the_same_windows():
    frames, _ = _frames(seed=13, n_packets=2)
    wins = _windows(frames).reshape(-1, CFG.cycles,
                                    2 * CFG.symbols_per_block)
    tcfg = interop.config_from_dict(dataclasses.asdict(FRAC))
    lag_j, ph_j, peak_j, frac_j = (np.array(a) for a in
                                   jrx._hunt(FRAC, jnp.asarray(wins)))
    lag_t, ph_t, peak_t, frac_t = trx._hunt(tcfg, torch.from_numpy(wins))
    det = peak_j > 0.5 * peak_j.max()            # rows holding a preamble
    assert det.sum() >= 2 * C
    assert np.array_equal(lag_t.numpy()[det], lag_j[det])
    assert np.array_equal(ph_t.numpy()[det], ph_j[det])
    assert np.allclose(peak_t.numpy()[det], peak_j[det], rtol=1e-5)
    assert np.abs(frac_t.numpy()[det] - frac_j[det]).max() < 1e-3
    assert np.abs(frac_j[det]).max() > 0.05      # the parabola did work
    assert np.all(np.abs(frac_t.numpy()) <= 0.5)

    pkt_j = np.asarray(jax.vmap(
        lambda w, l, p, f: jrx._extract_packet(FRAC, w, l, p, f))(
            jnp.asarray(wins), jnp.asarray(lag_j), jnp.asarray(ph_j),
            jnp.asarray(frac_j)))
    pkt_t = trx._extract_packet(
        tcfg, torch.from_numpy(wins), torch.from_numpy(lag_j),
        torch.from_numpy(ph_j), torch.from_numpy(frac_j))
    assert pkt_t.dtype == torch.complex64
    assert tuple(pkt_t.shape) == (wins.shape[0], CFG.pkt_window)
    assert np.abs(pkt_t.numpy() - pkt_j).max() < 1e-6

    # at frac = 0 the blend is the integer paths' plain comb
    grid = trx._extract_packet(tcfg, torch.from_numpy(wins), lag_t, ph_t,
                               torch.zeros_like(frac_t))
    planes = torch.view_as_real(torch.from_numpy(wins)).permute(0, 1, 3, 2)
    want = trx._extract_packet_planes(tcfg, planes, lag_t, ph_t)
    assert torch.equal(torch.view_as_real(grid).permute(0, 2, 1), want)


@pytest.mark.parametrize("frac_timing", [False, True])
def test_hunt_and_extraction_follow_frac_timing_as_jax(frac_timing):
    """``_hunt`` returns a zero ``frac`` and ``_extract_packet`` the plain
    comb when ``cfg.frac_timing`` is off, as the JAX functions do; with
    it on, the parabola and the blend."""
    frames, _ = _frames(seed=14, n_packets=1)
    wins = _windows(frames).reshape(-1, CFG.cycles,
                                    2 * CFG.symbols_per_block)
    cfg = CFG.replace(frac_timing=frac_timing)
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    lag_j, ph_j, peak_j, frac_j = (np.array(a) for a in
                                   jrx._hunt(cfg, jnp.asarray(wins)))
    lag_t, ph_t, peak_t, frac_t = trx._hunt(tcfg, torch.from_numpy(wins))
    det = peak_j > 0.5 * peak_j.max()            # rows holding a preamble
    assert det.sum() >= C
    assert np.array_equal(lag_t.numpy()[det], lag_j[det])
    assert np.array_equal(ph_t.numpy()[det], ph_j[det])
    assert frac_t.dtype == torch.float32 and frac_t.shape == peak_t.shape
    if frac_timing:
        assert np.abs(frac_t.numpy()[det] - frac_j[det]).max() < 1e-3
        assert np.abs(frac_j[det]).max() > 0.05
    else:
        assert not frac_j.any() and not frac_t.any()
    pkt_j = np.asarray(jax.vmap(
        lambda w, l, p, f: jrx._extract_packet(cfg, w, l, p, f))(
            jnp.asarray(wins), jnp.asarray(lag_j), jnp.asarray(ph_j),
            jnp.asarray(frac_j)))
    pkt_t = trx._extract_packet(
        tcfg, torch.from_numpy(wins), torch.from_numpy(lag_j),
        torch.from_numpy(ph_j), torch.from_numpy(frac_j)).numpy()
    if frac_timing:
        assert np.abs(pkt_t - pkt_j).max() < 1e-6
    else:
        assert np.array_equal(pkt_t, pkt_j)
        # the comb only: a frac handed in is not blended in
        assert np.array_equal(trx._extract_packet(
            tcfg, torch.from_numpy(wins), torch.from_numpy(lag_j),
            torch.from_numpy(ph_j), torch.full_like(frac_t, 0.4)).numpy(),
            pkt_j)


def test_unfused_decode_still_raises():
    """Once a raise, now a parity case: ``prod_rx_stream_pallas(
    fuse_decode=False)`` under ``frac_timing`` (the full-rate front-end,
    then the XLA back end ``prod_rx_backend``) on the fractionally
    delayed streams, against the JAX function in interpret mode, by the
    criterion above; every packet decodes, the state within 1e-6."""
    frames, bits = _frames()
    tcfg = interop.config_from_dict(dataclasses.asdict(FRAC))
    st_j, o_j = jrx.prod_rx_stream_pallas(
        FRAC, jrx.prod_rx_init(FRAC, (C,)), jnp.asarray(frames),
        descramble=False, block_channels=C, fuse_decode=False,
        interpret=True)
    o_j = jax.tree.map(np.asarray, o_j)
    st_t, o_t = prod_rx_stream_pallas(
        tcfg, prod_rx_init(tcfg, (C,), device="cpu"),
        torch.from_numpy(frames), descramble=False, fuse_decode=False)
    v = o_j.valid
    assert np.array_equal(o_t.valid.numpy(), v)
    assert np.array_equal(o_t.bits.numpy()[v], o_j.bits[v])
    assert np.array_equal(o_t.lag.numpy()[v], o_j.lag[v])
    assert np.array_equal(o_t.timing_phase.numpy()[v], o_j.timing_phase[v])
    assert np.array_equal(o_t.matches.numpy()[v], o_j.matches[v])
    assert np.abs(o_t.cfo_hz.numpy()[v] - o_j.cfo_hz[v]).max() < 0.5
    assert np.abs(o_t.eq_error.numpy()[v] - o_j.eq_error[v]).max() < 2e-3
    sent = bits.reshape(-1, CFG.bits_per_frame)
    for c in range(C):
        assert np.array_equal(o_t.bits.numpy()[:, c][v[:, c]], sent)
    for a, b in zip(interop.state_to_numpy(st_t),
                    jax.tree.map(np.asarray, st_j)):
        assert np.abs(a - b).max() <= 1e-6
