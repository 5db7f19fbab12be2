"""PyTorch port, every module that holds a kernel, at the two numerologies
that change the most kernel code, against the JAX launchers; and the
kernels' stated limits.

``tiny_payload`` (D = 2, 130 symbols a block: ragged front-end tasks,
rows that are not whole 16-byte units, the decode's shortest packet) and
``seg16`` (16 correlation segments of 8 chips: the hunt's half-chunk
tensor-core fragments), at the bench operating point.  The inputs: the
JAX package's TX stream (two scrambled packets) on C = 2 channels at
different delays with AWGN, every row with its own mixer phase and
downmixed halo.  One JAX run in interpret mode per launcher and
numerology, each held to the tolerances of the reference numerology's
files: ``fused_frontend_decim`` (f32 planes to 2e-5, bf16 planes to one
ulp, the state out exact), ``fused_frontend`` (1e-6, the state out
exact), ``fused_hunt_decode_decim``, ``fused_decode_extract`` and
``fused_decode`` (identical valid flags, dibits on valid rows, lag and
phase; |dcfo| < 0.5 Hz, |deq_error| < 2e-3).

The limits (``ops/_build.kernel_limits``, ``kernel_geometry``): no define
at the reference numerology, all nine at each named one (the thirty
of ``NUMEROLOGIES``), and a config just outside each limit refused with
the limit's name.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.ops import decode_pallas as jdec
from singlecarrier_tpu.ops import frontend_pallas as jfe
from singlecarrier_tpu_torch import DEFAULT_CONFIG as TCFG
from singlecarrier_tpu_torch.interop import (config_from_dict,
                                             planes_from_numpy)
from singlecarrier_tpu_torch.ops import _build, decode, frontend

NAMES = ("tiny_payload", "seg16")
C = 2


def _bench(name):
    cfg = CFG.replace(**_build.NUMEROLOGIES[name])
    return cfg.replace(decim_dtype="bf16", hunt_dtype="int8",
                       ls_refit_symbols=min(128, cfg.frame_symbols))


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _frontend_cfg(name):
    """The config of ``name``'s TX and front-end: the hunt's segments and
    the CFO DFT's size change neither, so the numerologies that differ
    only there share one front-end run."""
    return _bench(name).replace(corr_segments=CFG.corr_segments,
                                cfo_nfft=CFG.cfo_nfft)


def _rows(name):
    """(pcm [N, n], phase_r, phase_i, tail_r, tail_i) numpy rows in
    (block, channel) order, N = blocks x C."""
    return _rows_of(_frontend_cfg(name))


@functools.lru_cache(maxsize=None)
def _rows_of(cfg, seed=9):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (2, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n, halo = cfg.frame_size, cfg.ntaps - 1
    nb = -(-(len(pcm) + n) // n) + 1
    x = np.zeros((C, nb * n))
    for c, d in enumerate((n // 5, n - 7)):
        x[c, d:d + len(pcm)] = pcm
    x += rng.normal(0, 1500.0, x.shape)
    frames = np.clip(x, -32768, 32767).astype(np.int16).reshape(C, nb, n)
    N = nb * C
    ph = rng.uniform(0, 2 * np.pi, N)
    return (frames.transpose(1, 0, 2).reshape(N, n).copy(),
            np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32),
            (rng.normal(size=(N, halo)) * 0.3).astype(np.float32),
            (rng.normal(size=(N, halo)) * 0.3).astype(np.float32))


def _jax_frontend(name):
    """The JAX kernel's row-major f32 planes [N, cyc, 2, n_sym] and
    state out, numpy."""
    return _jax_frontend_of(_frontend_cfg(name))


@functools.lru_cache(maxsize=None)
def _jax_frontend_of(cfg):
    out = jfe.fused_frontend_decim(
        cfg, *(jnp.asarray(a) for a in _rows_of(cfg)),
        block_channels=C, transposed=False, interpret=True)
    return tuple(np.asarray(a) for a in out)


def _planes(name):
    """(dprev0, dcur) [cyc, 2, rows, n_sym] bf16 planes of the JAX
    front-end's output: block 0 is the carried state."""
    dec = _jax_frontend(name)[0].transpose(1, 2, 0, 3)
    dec = np.asarray(jnp.asarray(dec).astype(jnp.bfloat16))
    return dec[:, :, :C].copy(), dec[:, :, C:].copy()


@functools.lru_cache(maxsize=None)
def _hunted_windows(name):
    """(padded windows [N, cyc, 2, wp], lag, phase, peak, packets) as the
    ``fuse_hunt=False`` path builds them, the hunt the JAX package's."""
    cfg = _bench(name)
    dec = _jax_frontend(name)[0]
    n_sym, off = cfg.symbols_per_block, cfg.eq_length // 2
    dec = dec.reshape(-1, C, cfg.cycles, 2, n_sym)
    wins = np.concatenate([dec[:-1], dec[1:]], -1).reshape(
        -1, cfg.cycles, 2, 2 * n_sym)
    wp = -(-max(n_sym - 1 + cfg.pkt_window, off + 2 * n_sym) // 128) * 128
    wins = np.pad(wins, ((0, 0),) * 3 + ((off, wp - off - 2 * n_sym),))
    lag, ph, peak = (np.array(a) for a in jrx._hunt_planes(
        cfg, jnp.asarray(wins), col_offset=off))
    pkt = np.array(jrx._extract_packet_planes(
        cfg, jnp.asarray(wins[..., off:off + 2 * n_sym]), jnp.asarray(lag),
        jnp.asarray(ph)))
    return wins, lag, ph, peak, pkt


def _decisions(cfg, got, want, lag=None):
    """The decision-level criterion on stat dicts (numpy): valid, dibits,
    matches, and with hunt slots lag and phase, on valid rows; |dcfo| and
    |deq_error| within 0.5 Hz and 2e-3.  Returns the valid count."""
    v = want["gated"] & (want["matches"] > cfg.match_threshold)
    assert np.array_equal(
        got["gated"] & (got["matches"] > cfg.match_threshold), v)
    for k in ("dibits", "matches", *(("lag", "phase_idx") if lag else ())):
        assert np.array_equal(got[k][v], want[k][v]), k
    assert np.abs(got["cfo_hz"][v] - want["cfo_hz"][v]).max() < 0.5
    assert np.abs(got["eq_error"][v] - want["eq_error"][v]).max() < 2e-3
    assert np.allclose(got["energy"], want["energy"], rtol=1e-5)
    return int(v.sum())


@pytest.mark.parametrize("name", NAMES)
def test_frontend_rows_match_jax(name):
    cfg = _bench(name)
    tcfg = _tcfg(cfg)
    want = _jax_frontend(name)
    rows = [torch.from_numpy(a) for a in _rows(name)]
    got = frontend.fused_frontend_decim(tcfg, *rows, transposed=False)
    assert got[0].dtype == torch.float32
    assert tuple(got[0].shape) == want[0].shape == (
        rows[0].shape[0], cfg.cycles, 2, cfg.symbols_per_block)
    assert np.abs(got[0].numpy() - want[0]).max() < 2e-5
    assert np.abs(want[0]).max() > 0.5       # real signal went through
    for a, b in zip(want[1:], got[1:]):     # the state out: exact
        assert np.array_equal(a, b.numpy())
    # the transposed bf16 planes: one ulp of the JAX kernel's f32 sums
    t = frontend.frontend_rows(tcfg, *rows, transposed=True)
    assert t.dtype == torch.bfloat16
    w = want[0].transpose(1, 2, 0, 3)
    _, e = np.frexp(np.maximum(np.abs(w), 1e-30))
    assert np.all(np.abs(t.float().numpy() - w) <= np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("name", NAMES)
def test_frontend_full_matches_jax(name):
    cfg = _bench(name)
    pcm, *st = (a[C:2 * C] for a in _rows(name))     # block 1
    want = jfe.fused_frontend(cfg, jnp.asarray(pcm),
                              *(jnp.asarray(a) for a in st),
                              block_channels=C, interpret=True)
    got = frontend.fused_frontend(_tcfg(cfg), torch.from_numpy(pcm.copy()),
                                  *(torch.from_numpy(a.copy()) for a in st))
    for w, g in zip(want[:2], got[:2]):
        w = np.asarray(w)
        assert tuple(g.shape) == (C, cfg.frame_size)
        assert np.abs(g.numpy() - w).max() < 1e-6
        assert np.abs(w).max() > 0.5
    for w, g in zip(want[2:], got[2:]):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_hunt_and_extract_decode_match_jax(name):
    cfg = _bench(name)
    dprev0, dcur = _planes(name)
    want = jax.tree.map(np.asarray, jdec.fused_hunt_decode_decim(
        cfg, jnp.asarray(dprev0), jnp.asarray(dcur), channels=C,
        block_channels=C, interpret=True))
    tcfg = _tcfg(cfg)
    tp, tc = planes_from_numpy((dprev0, dcur), device="cpu")
    got = decode.fused_hunt_decode_decim(tcfg, tp, tc, channels=C)
    got = {k: v.numpy() for k, v in got.items()}
    assert got.keys() == want.keys()
    assert _decisions(cfg, got, want, lag=True) >= 2 * C
    v = want["gated"] & (want["matches"] > cfg.match_threshold)
    assert np.allclose(got["peak"][v], want["peak"][v], rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_decode_launchers_match_jax(name):
    """``fused_decode_extract`` on the padded windows and ``fused_decode``
    on the packets the JAX hunt finds there, each against its JAX
    launcher, and the two against each other to the bit."""
    cfg = _bench(name)
    tcfg = _tcfg(cfg)
    wins, lag, ph, peak, pkt = _hunted_windows(name)
    N = wins.shape[0]
    want = jax.tree.map(np.asarray, jdec.fused_decode_extract(
        cfg, jnp.asarray(wins), jnp.asarray(lag), jnp.asarray(ph),
        jnp.asarray(peak), block_channels=N, interpret=True))
    got = decode.fused_decode_extract(
        tcfg, torch.from_numpy(wins), torch.from_numpy(lag),
        torch.from_numpy(ph), torch.from_numpy(peak))
    got = {k: v.numpy() for k, v in got.items()}
    assert _decisions(cfg, got, want) >= 2 * C
    want = jax.tree.map(np.asarray, jdec.fused_decode(
        cfg, jnp.asarray(pkt[:, 0]), jnp.asarray(pkt[:, 1]),
        jnp.asarray(peak), block_channels=N, interpret=True))
    got2 = decode.fused_decode(tcfg, torch.from_numpy(pkt[:, 0].copy()),
                               torch.from_numpy(pkt[:, 1].copy()),
                               torch.from_numpy(peak))
    got2 = {k: v.numpy() for k, v in got2.items()}
    assert _decisions(cfg, got2, want) >= 2 * C
    for k in got:
        assert np.array_equal(got[k], got2[k]), k


# ------------------------------------------------------------ the limits

# (frame_size, cycles, ntaps, D, pkt_window, eq_length, corr_segments,
# cfo_nfft) of each named numerology, from the configs the JAX package
# runs
GEOMETRY = {
    "alt_9600": (1504, 4, 49, 248, 384, 5, 8, 512),
    "tiny_payload": (650, 5, 49, 2, 136, 5, 8, 512),
    "mid_payload": (1000, 5, 49, 72, 208, 5, 8, 512),
    "ns4": (1260, 5, 49, 124, 256, 5, 8, 512),
    "eq7": (1880, 5, 49, 248, 384, 7, 8, 512),
    "seg4": (1880, 5, 49, 248, 384, 5, 4, 512),
    "seg16": (1880, 5, 49, 248, 384, 5, 16, 512),
    "nfft1024": (1880, 5, 49, 248, 384, 5, 8, 1024),
    "eq9": (1880, 5, 49, 248, 384, 9, 8, 512),
    "eq16": (1880, 5, 49, 248, 392, 16, 8, 512),
    "cyc6": (2256, 6, 49, 248, 384, 5, 8, 512),
    "cyc10": (3760, 10, 49, 248, 384, 5, 8, 512),
    "ns9": (2035, 5, 49, 279, 416, 5, 8, 512),
    "ns16": (3120, 5, 49, 496, 632, 5, 8, 512),
    "wide_corner": (6240, 10, 49, 496, 640, 16, 8, 512),
    "seg1": (1880, 5, 49, 248, 384, 5, 1, 512),
    "seg2": (1880, 5, 49, 248, 384, 5, 2, 512),
    "nfft128": (1880, 5, 49, 248, 384, 5, 8, 128),
    "nfft4096": (1880, 5, 49, 248, 384, 5, 8, 4096),
    "nfft16": (1880, 5, 49, 248, 384, 5, 8, 16),
    "nfft1001": (1880, 5, 49, 248, 384, 5, 8, 1001),
    "nfft8192": (1880, 5, 49, 248, 384, 5, 8, 8192),
    "nfft32768": (1880, 5, 49, 248, 384, 5, 8, 32768),
    "taps25": (1880, 5, 25, 248, 384, 5, 8, 512),
    "taps45": (1880, 5, 45, 248, 384, 5, 8, 512),
    "eq24": (1880, 5, 49, 248, 400, 24, 8, 512),
    "eq32": (1880, 5, 49, 248, 408, 32, 8, 512),
    "ns24": (4360, 5, 49, 744, 880, 5, 8, 512),
    "ns32": (5600, 5, 49, 992, 1128, 5, 8, 512),
    "ns48": (8080, 5, 49, 1488, 1624, 5, 8, 512),
}


def test_the_reference_geometry_takes_no_define():
    for cfg in (TCFG, TCFG.replace(decim_dtype="bf16", hunt_dtype="int8"),
                TCFG.replace(center=1500.0, alpha=0.5, mixer_fold=True)):
        assert _build.kernel_geometry(cfg) == ()


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_each_numerology_has_its_defines(name):
    cfg = TCFG.replace(**_build.NUMEROLOGIES[name])
    n, cyc, ntaps, D, pkt, L, nseg, nfft = GEOMETRY[name]
    assert _build.kernel_geometry(cfg) == (
        f"SC_N_SAMP={n}", f"SC_CYC={cyc}", f"SC_NTAPS={ntaps}", "SC_P=128",
        f"SC_NSEG={nseg}", f"SC_D={D}", f"SC_L={L}", f"SC_NFFT={nfft}",
        f"SC_PKT={pkt}")
    _build.kernel_limits(cfg)


NFFT_LIMIT = "2 <= cfo_nfft <= 32768"


@pytest.mark.parametrize("kw,limit", [
    ({"preamble_length": 64}, "preamble_length == 128"),
    ({"corr_segments": 32}, "corr_segments in (1, 2, 4, 8, 16)"),
    ({"ntaps": 51}, "9 <= ntaps <= 49"),
    ({"ntaps": 7}, "9 <= ntaps <= 49"),
    ({"fs": 17600.0, "fine_timing_offset": 3}, "2 <= cycles <= 10"),
    ({"ns": 49}, "symbols_per_block <= 1616"),
    ({"eq_length": 33}, "1 <= eq_length <= 32"),
    ({"cfo_nfft": 65536}, NFFT_LIMIT),
    ({"cfo_nfft": 1}, NFFT_LIMIT),
], ids=["preamble", "segments", "ntaps", "ntaps_short", "cycles", "symbols",
        "eq_length", "nfft", "nfft_short"])
def test_a_config_outside_the_limits_is_refused_by_name(kw, limit):
    cfg = TCFG.replace(**kw)
    for fn in (_build.kernel_limits, _build.kernel_geometry):
        with pytest.raises(NotImplementedError, match=re.escape(limit)):
            fn(cfg)


@pytest.mark.parametrize("nfft", [2, 3, 16, 31, 33, 1001, 1025, 4097,
                                  32767, 32768])
def test_every_cfo_nfft_from_2_to_32768_is_accepted(nfft):
    """Any integer size: fewer bins than a warp's lanes, sizes no multiple
    of 4 or 32, either side of the 1024 bins past which the DFT keeps a
    running first maximum, and the limit."""
    cfg = TCFG.replace(cfo_nfft=nfft)
    _build.kernel_limits(cfg)
    assert f"SC_NFFT={nfft}" in _build.kernel_geometry(cfg)
