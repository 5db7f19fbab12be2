"""PyTorch port, the decode launchers vs the JAX kernels.

``fused_decode`` (packets in), ``fused_decode_extract`` (padded hunt
windows + lag/phase in) and ``fused_hunt_decode_decim`` (decim planes
in) against the JAX kernels of the same names in interpret mode, on the
same inputs: hunt windows cut by the JAX front-end kernel from a noisy
``tx_stream``, lag/phase/peak from the JAX package's plain hunt.  Held
to the decision-level criterion of ``tools/tpu_parity.py``: identical
valid flags, identical dibits on valid rows, identical lag and phase on
detected rows, |dcfo| < 0.5 Hz, |deq_error| < 2e-3 (the f32 sums of the
decode run in another order); matches and the gate energy (to 1e-5
relative) besides.  Descrambling on and off.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.ops import decode_pallas as jdec
from singlecarrier_tpu.ops.frontend_pallas import fused_frontend_decim
from singlecarrier_tpu_torch.config import ModemConfig as TorchConfig
from singlecarrier_tpu_torch.interop import planes_from_numpy
from singlecarrier_tpu_torch.ops import decode

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
CONFIGS = {"bench": BENCH, "default": CFG}
C = 4


def _tcfg(cfg):
    return TorchConfig(**dataclasses.asdict(cfg))


def _copies(fn):
    """``fn`` run once per module for each set of arguments (a JAX run in
    interpret mode that several cases share); each call returns copies of
    its arrays."""
    once = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        return tuple(a.copy() if isinstance(a, np.ndarray) else a
                     for a in once(*args, **kw))
    return wrapper


@_copies
def _planes(cfg, seed, transposed):
    """Decim planes of a noisy 3-packet stream, C channels with distinct
    delays, rows in (block, channel) order."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n = cfg.frame_size
    nb = -(-(len(pcm) + 2 * n) // n)
    x = np.zeros((C, nb * n))
    for c in range(C):
        d = int(rng.integers(0, n))
        x[c, d:d + len(pcm)] = pcm
    x += rng.normal(0, 1500.0, x.shape)
    frames = np.clip(x, -32768, 32767).astype(np.int16).reshape(C, nb, n)
    N = nb * C
    f = jnp.asarray(frames.transpose(1, 0, 2).reshape(N, n))
    ph = rng.uniform(0, 2 * np.pi, N)
    dec = fused_frontend_decim(
        cfg, f, jnp.asarray(np.cos(ph), jnp.float32),
        jnp.asarray(np.sin(ph), jnp.float32),
        jnp.zeros((N, cfg.ntaps - 1)), jnp.zeros((N, cfg.ntaps - 1)),
        transposed=transposed, interpret=True)[0]
    return np.asarray(dec), nb


@_copies
def _hunted_windows(cfg, seed):
    """(padded windows [N, cyc, 2, 768], lag, phase, peak) as the
    ``fuse_hunt=False`` path of ``prod_rx_batch`` builds them."""
    dec, nb = _planes(cfg, seed, transposed=False)
    dec = dec.reshape(nb, C, cfg.cycles, 2, -1)
    off, n_sym = cfg.eq_length // 2, cfg.symbols_per_block
    wins = np.concatenate([dec[:-1], dec[1:]], -1).reshape(
        (nb - 1) * C, cfg.cycles, 2, -1)
    wins = np.pad(wins, ((0, 0),) * 3 + ((off, 768 - off - 2 * n_sym),))
    lag, ph, peak = (np.array(a) for a in jrx._hunt_planes(
        cfg, jnp.asarray(wins), col_offset=off))
    return wins, lag, ph, peak


def _assert_decode_parity(cfg, got, want, min_valid):
    want = jax.tree.map(np.asarray, want)
    got = {k: v.numpy() for k, v in got.items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    valid = want["gated"] & (want["matches"] > cfg.match_threshold)
    assert valid.sum() >= min_valid
    assert np.array_equal(
        got["gated"] & (got["matches"] > cfg.match_threshold), valid)
    v = valid
    assert np.array_equal(got["dibits"][v], want["dibits"][v])
    assert np.array_equal(got["matches"][v], want["matches"][v])
    assert np.abs(got["cfo_hz"][v] - want["cfo_hz"][v]).max() < 0.5
    assert np.abs(got["eq_error"][v] - want["eq_error"][v]).max() < 2e-3
    assert np.allclose(got["energy"], want["energy"], rtol=1e-5)
    return v


@pytest.mark.parametrize("descramble", [True, False],
                         ids=["descramble", "raw"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_decode_extract_matches_jax_kernel(name, descramble):
    cfg = CONFIGS[name]
    wins, lag, ph, peak = _hunted_windows(cfg, seed=13)
    N = wins.shape[0]
    want = jdec.fused_decode_extract(
        cfg, jnp.asarray(wins), jnp.asarray(lag), jnp.asarray(ph),
        jnp.asarray(peak), descramble=descramble, block_channels=N,
        interpret=True)
    got = decode.fused_decode_extract(
        _tcfg(cfg), torch.from_numpy(wins), torch.from_numpy(lag),
        torch.from_numpy(ph), torch.from_numpy(peak), descramble=descramble,
        block_channels=N, interpret=True)
    _assert_decode_parity(cfg, got, want, min_valid=8)


@pytest.mark.parametrize("descramble", [True, False],
                         ids=["descramble", "raw"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_decode_matches_jax_kernel(name, descramble):
    cfg = CONFIGS[name]
    wins, lag, ph, peak = _hunted_windows(cfg, seed=14)
    N = wins.shape[0]
    off = cfg.eq_length // 2
    pkt = np.array(jrx._extract_packet_planes(
        cfg, jnp.asarray(wins[..., off:off + 2 * cfg.symbols_per_block]),
        jnp.asarray(lag), jnp.asarray(ph)))
    want = jdec.fused_decode(cfg, jnp.asarray(pkt[:, 0]),
                             jnp.asarray(pkt[:, 1]), jnp.asarray(peak),
                             descramble=descramble, block_channels=N,
                             interpret=True)
    got = decode.fused_decode(
        _tcfg(cfg), torch.from_numpy(pkt[:, 0].copy()),
        torch.from_numpy(pkt[:, 1].copy()), torch.from_numpy(peak),
        descramble=descramble, block_channels=N, interpret=True)
    _assert_decode_parity(cfg, got, want, min_valid=8)
    # the two launchers decode the same packets to the same rows
    tcfg = _tcfg(cfg)
    a = decode.fused_decode_ref(tcfg, torch.from_numpy(pkt[:, 0].copy()),
                                torch.from_numpy(pkt[:, 1].copy()),
                                torch.from_numpy(peak),
                                descramble=descramble)
    b = decode.fused_decode_extract_ref(
        tcfg, torch.from_numpy(wins), torch.from_numpy(lag),
        torch.from_numpy(ph), torch.from_numpy(peak), descramble=descramble)
    assert a.shape == (N, cfg.frame_symbols + 8) and torch.equal(a, b)
    assert bool((a[:, cfg.frame_symbols + 5:] == 0).all())


@pytest.mark.parametrize("descramble", [True, False],
                         ids=["descramble", "raw"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_hunt_decode_decim_matches_jax_kernel(name, descramble):
    cfg = CONFIGS[name]
    dec, _ = _planes(cfg, seed=15, transposed=True)
    dprev0, dcur = dec[:, :, :C], dec[:, :, C:]
    want = jdec.fused_hunt_decode_decim(
        cfg, jnp.asarray(dprev0), jnp.asarray(dcur), channels=C,
        descramble=descramble, block_channels=C, interpret=True)
    tp, tc = planes_from_numpy((dprev0, dcur), device="cpu")
    got = decode.fused_hunt_decode_decim(
        _tcfg(cfg), tp, tc, channels=C, descramble=descramble,
        block_channels=C, interpret=True)
    v = _assert_decode_parity(cfg, got, want, min_valid=8)
    want = jax.tree.map(np.asarray, want)
    assert np.array_equal(got["lag"].numpy()[v], want["lag"][v])
    assert np.array_equal(got["phase_idx"].numpy()[v], want["phase_idx"][v])
    assert np.allclose(got["peak"].numpy()[v], want["peak"][v], rtol=1e-5)


def test_launchers_check_their_operands():
    tcfg = _tcfg(CFG)
    z = torch.zeros
    with pytest.raises(ValueError, match="windows"):
        decode.fused_decode_extract(tcfg, z((2, 5, 2, 700)),
                                    z(2, dtype=torch.int32),
                                    z(2, dtype=torch.int32), z(2))
    with pytest.raises(ValueError, match="expected"):
        decode.fused_decode(tcfg, z((2, 300)), z((2, 300)), z(2))
    with pytest.raises(ValueError, match="channels"):
        decode.fused_hunt_decode_decim(tcfg, z((5, 2, 2, 376)),
                                       z((5, 2, 4, 376)), channels=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.fused_hunt_decode_decim(tcfg, z((5, 2, 4, 376)),
                                       z((5, 2, 4, 376)), channels=4,
                                       stage="cfo")
    # the gate stage runs: zero planes gate nothing
    dec = decode.fused_hunt_decode_decim(tcfg, z((5, 2, 4, 376)),
                                         z((5, 2, 8, 376)), channels=4,
                                         stage="gate")
    assert dec["gated"].shape == (8,) and not bool(dec["gated"].any())
