"""PyTorch port, the plain-tensor hunt of the unfused batch paths vs JAX.

``_hunt_planes`` and ``_extract_packet_planes`` are plain XLA in the JAX
package and plain PyTorch in the port.  The same hunt windows -- cut
from a noisy ``tx_stream`` by the JAX front-end kernel -- go through
both, at ``hunt_dtype`` bf16 and int8, with and without the column
offset of the padded window layout.  Lag and phase must be equal on
rows that hold a packet (on empty windows the espan statistic is ~0/~0
and the band matmul's f32 sum order decides); the peak to 1e-5 relative
(int8 sums are exact integers, bf16 sums differ only in f32 order); the
extracted packets exactly (pure selection).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.ops.frontend_pallas import fused_frontend_decim
from singlecarrier_tpu_torch.config import ModemConfig as TorchConfig
from singlecarrier_tpu_torch.modem import rx_production as trx

C = 4


def _tcfg(cfg):
    return TorchConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _windows(seed):
    """[N, cyc, 2, 2*n_sym] f32 hunt windows of a noisy 3-packet stream on
    C channels with distinct delays (one JAX run per seed and module;
    the callers only read them)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n = CFG.frame_size
    nb = -(-(len(pcm) + 2 * n) // n)
    x = np.zeros((C, nb * n))
    for c in range(C):
        d = int(rng.integers(0, n))
        x[c, d:d + len(pcm)] = pcm
    x += rng.normal(0, 1500.0, x.shape)
    frames = np.clip(x, -32768, 32767).astype(np.int16).reshape(C, nb, n)
    N = nb * C
    f = jnp.asarray(frames.transpose(1, 0, 2).reshape(N, n))
    dec = fused_frontend_decim(
        CFG, f, jnp.ones((N,)), jnp.zeros((N,)),
        jnp.zeros((N, CFG.ntaps - 1)), jnp.zeros((N, CFG.ntaps - 1)),
        interpret=True)[0]                       # [N, cyc, 2, n_sym]
    dec = np.asarray(dec).reshape(nb, C, CFG.cycles, 2, -1)
    wins = np.concatenate([dec[:-1], dec[1:]], -1).reshape(
        (nb - 1) * C, CFG.cycles, 2, -1)
    return np.ascontiguousarray(wins)


def test_band_matrices_equal_jax():
    args = (CFG.symbols_per_block, CFG.corr_segments, CFG.preamble_length)
    assert np.array_equal(trx._segment_band_matrix(*args),
                          jrx._segment_band_matrix(*args))
    assert np.array_equal(trx._segment_band_matrix(40, 4, 32),
                          jrx._segment_band_matrix(40, 4, 32))
    assert np.array_equal(
        trx._energy_band_matrix(CFG.symbols_per_block, CFG.preamble_length),
        jrx._energy_band_matrix(CFG.symbols_per_block, CFG.preamble_length))
    for cfg in (CFG, CFG.replace(hunt_dtype="int8")):
        assert trx._hunt_power_scale(_tcfg(cfg)) == \
            jrx._hunt_power_scale(cfg)


@pytest.mark.parametrize("col_offset", [0, 2], ids=["plain", "padded"])
@pytest.mark.parametrize("hunt_dtype", ["bf16", "int8"])
def test_hunt_planes_and_extraction_match_jax(hunt_dtype, col_offset,
                                              monkeypatch):
    cfg = CFG.replace(hunt_dtype=hunt_dtype)
    tcfg = _tcfg(cfg)
    wins = _windows(seed=9)
    if col_offset:
        wins = np.pad(wins, ((0, 0),) * 3 + ((col_offset, 14),))
    N = wins.shape[0]
    lag_j, ph_j, peak_j = (np.array(a) for a in jrx._hunt_planes(
        cfg, jnp.asarray(wins), col_offset=col_offset))
    # walk the rows in uneven chunks: the result must not depend on it
    monkeypatch.setattr(trx, "_HUNT_ROWS", 7)
    lag, ph, peak = trx._hunt_planes(tcfg, torch.from_numpy(wins),
                                     col_offset=col_offset)
    assert lag.dtype == ph.dtype == torch.int32 and peak.dtype == torch.float32
    assert tuple(lag.shape) == tuple(ph.shape) == tuple(peak.shape) == (N,)

    # rows that hold a packet: the gate statistic of a clean preamble is
    # ~16x the window energy, noise stays under ~4x
    t = torch.from_numpy(wins[..., col_offset:])
    pk = trx._extract_packet_planes(tcfg, t[..., :2 * CFG.symbols_per_block]
                                    .contiguous(), torch.from_numpy(lag_j),
                                    torch.from_numpy(ph_j))
    off, P = CFG.eq_length // 2, CFG.preamble_length
    energy = (pk[:, :, off:off + P] ** 2).sum(dim=(1, 2)).numpy()
    det = peak_j > 7.0 * energy
    assert det.sum() >= 8
    assert np.array_equal(lag.numpy()[det], lag_j[det])
    assert np.array_equal(ph.numpy()[det], ph_j[det])
    assert np.allclose(peak.numpy()[det], peak_j[det], rtol=1e-5)
    # whole-array view: the great majority of rows agree outright
    assert (lag.numpy() == lag_j).mean() > 0.9


def test_extract_packet_planes_matches_jax_and_pads_with_zeros():
    wins = _windows(seed=10)
    N = wins.shape[0]
    rng = np.random.default_rng(1)
    lag = rng.integers(0, CFG.symbols_per_block, N).astype(np.int32)
    lag[:3] = (0, CFG.symbols_per_block - 1, CFG.symbols_per_block - 2)
    ph = rng.integers(0, CFG.cycles, N).astype(np.int32)
    want = np.asarray(jrx._extract_packet_planes(
        CFG, jnp.asarray(wins), jnp.asarray(lag), jnp.asarray(ph)))
    got = trx._extract_packet_planes(_tcfg(CFG), torch.from_numpy(wins),
                                     torch.from_numpy(lag),
                                     torch.from_numpy(ph)).numpy()
    assert got.shape == (N, 2, CFG.pkt_window)
    assert np.array_equal(got, want)
    # lag 375 reads past the 752-wide window: zero right pad
    assert np.all(got[1, :, -5:] == 0.0) and np.any(got[1, :, :300] != 0.0)
    # the left pad: a packet at lag 0 starts with eq_length//2 zeros
    assert np.all(got[0, :, :CFG.eq_length // 2] == 0.0)


@pytest.mark.parametrize("norm", ["energy", "none"])
def test_other_hunt_norms_still_raise(norm):
    """``hunt_norm`` energy and none raised here until the kernels took
    them; now the plain hunt runs them and equals JAX's on the rows that
    hold a packet (lag, phase; the peak to 1e-5 relative)."""
    cfg = CFG.replace(hunt_norm=norm)
    wins = _windows(seed=9)
    lag_j, ph_j, peak_j = (np.array(a) for a in jrx._hunt_planes(
        cfg, jnp.asarray(wins)))
    lag, ph, peak = trx._hunt_planes(_tcfg(cfg), torch.from_numpy(wins))
    pk = trx._extract_packet_planes(_tcfg(cfg), torch.from_numpy(wins),
                                    torch.from_numpy(lag_j),
                                    torch.from_numpy(ph_j))
    off, P = CFG.eq_length // 2, CFG.preamble_length
    energy = (pk[:, :, off:off + P] ** 2).sum(dim=(1, 2)).numpy()
    det = peak_j > 7.0 * energy
    assert det.sum() >= 8
    assert np.array_equal(lag.numpy()[det], lag_j[det])
    assert np.array_equal(ph.numpy()[det], ph_j[det])
    assert np.allclose(peak.numpy()[det], peak_j[det], rtol=1e-5)
