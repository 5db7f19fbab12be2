"""PyTorch port, the whole slice: ``prod_rx_batch(fuse_frontend=True)``.

The port runs the same int16 streams as the JAX one-kernel path
(``prod_rx_batch(fuse_frontend=True, interpret=True)``), at the bench
operating point and the library default, with the stream split across
two calls.  The port's first call starts from the JAX initial state and
its second from the JAX state after the first call, both carried
through ``interop.planes_from_numpy``, so each call is compared from the
same state.  Decisions are held to ``tools/tpu_parity.py``'s criterion
(identical valid, bits on valid rows, lag and phase on detected rows,
|dcfo| < 0.5 Hz, |deq_error| < 2e-3); the carried state to 1e-6 (phase,
tail) and the front-end's tolerance (decim planes): one bf16 ulp, or in
f32 the reassociation of the 49-term filter sum (< 2e-5,
test_torch_frontend.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch.interop import (config_from_dict,
                                             planes_from_numpy)
from singlecarrier_tpu_torch.modem import prod_rx_batch, prod_rx_init_planes
from singlecarrier_tpu_torch.ops.fused_rx import _advances

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
C = 4
GOLDEN_DELAYS = (0, 3, 377, 1879)


def _golden_frames(golden):
    tx = golden["tx_pcm"]
    n = CFG.frame_size
    nb = -(-(len(tx) + max(GOLDEN_DELAYS)) // n)
    x = np.zeros((C, nb * n), np.int16)
    for c, d in enumerate(GOLDEN_DELAYS):
        x[c, d:d + len(tx)] = tx
    return x.reshape(C, nb, n).transpose(1, 0, 2).copy()


def _awgn_frames(seed=21):
    """3 random-payload scrambled packets per channel, distinct delays,
    AWGN at ~15 dB below the data amplitude."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n = CFG.frame_size
    nb = 6
    x = np.zeros((C, nb * n))
    for c in range(C):
        d = int(rng.integers(0, 1400))
        x[c, d:d + len(pcm)] = pcm[:nb * n - d]
    x += rng.normal(0, 2000.0, x.shape)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    return x.reshape(C, nb, n).transpose(1, 0, 2).copy(), bits


def _run_both(cfg, frames, descramble):
    half = frames.shape[0] // 2
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    st_j = jrx.prod_rx_init_planes(cfg, C)
    outs_j, outs_t, states = [], [], []
    for part in (frames[:half], frames[half:]):
        st_t = planes_from_numpy([np.asarray(a) for a in st_j],
                                 device="cpu")
        st_j, o_j = jrx.prod_rx_batch(
            cfg, st_j, jnp.asarray(part), descramble=descramble,
            block_channels=C, decode_block_channels=C, fuse_frontend=True,
            interpret=True)
        st_t, o_t = prod_rx_batch(tcfg, st_t, torch.from_numpy(part),
                                  descramble=descramble, fuse_frontend=True)
        outs_j.append(jax.tree.map(np.asarray, o_j))
        outs_t.append(o_t)
        states.append(([np.asarray(a) for a in st_j], st_t))
    return outs_j, outs_t, states


def _assert_parity(o_t, o_j):
    v = o_j.valid
    assert np.array_equal(o_t.valid.numpy(), v)
    assert np.array_equal(o_t.bits.numpy()[v], o_j.bits[v])
    assert np.array_equal(o_t.lag.numpy()[v], o_j.lag[v])
    assert np.array_equal(o_t.timing_phase.numpy()[v], o_j.timing_phase[v])
    assert np.array_equal(o_t.matches.numpy()[v], o_j.matches[v])
    if v.any():
        assert np.abs(o_t.cfo_hz.numpy()[v] - o_j.cfo_hz[v]).max() < 0.5
        assert np.abs(o_t.eq_error.numpy()[v] - o_j.eq_error[v]).max() < 2e-3


def _assert_state_close(st_j, st_t):
    for a, b in zip(st_j[:4], st_t[:4]):
        assert np.abs(a - b.numpy()).max() <= 1e-6
    dj = st_j[4].astype(np.float32)
    err = np.abs(dj - st_t[4].float().numpy())
    if st_t[4].dtype == torch.bfloat16:
        _, e = np.frexp(np.maximum(np.abs(dj), 1e-30))
        assert np.all(err <= np.ldexp(1.0, e - 8))
    else:
        assert err.max() < 2e-5


@pytest.mark.parametrize("cfg", [BENCH, CFG], ids=["bench", "default"])
def test_golden_stream_matches_jax_and_decodes(cfg, golden):
    frames = _golden_frames(golden)
    outs_j, outs_t, states = _run_both(cfg, frames, descramble=False)
    for o_t, o_j in zip(outs_t, outs_j):
        _assert_parity(o_t, o_j)
    for st_j, st_t in states:
        _assert_state_close(st_j, st_t)
    valid = torch.cat([o.valid for o in outs_t]).numpy()
    bits = torch.cat([o.bits for o in outs_t]).numpy()
    ref = golden["tx_bits"].reshape(10, CFG.bits_per_frame)
    for c in range(C):
        got = bits[:, c][valid[:, c]]
        assert got.shape == ref.shape          # 10/10 packets
        # exact except the TX-truncated tail (last 5 symbols = 10 bits)
        assert np.array_equal(got[:, :-10], ref[:, :-10])


@pytest.mark.parametrize("cfg", [BENCH, CFG], ids=["bench", "default"])
def test_noisy_random_stream_matches_jax_and_decodes(cfg):
    frames, bits = _awgn_frames()
    outs_j, outs_t, states = _run_both(cfg, frames, descramble=True)
    for o_t, o_j in zip(outs_t, outs_j):
        _assert_parity(o_t, o_j)
    for st_j, st_t in states:
        _assert_state_close(st_j, st_t)
    valid = torch.cat([o.valid for o in outs_t]).numpy()
    got = torch.cat([o.bits for o in outs_t]).numpy()
    sent = bits.reshape(3, CFG.bits_per_frame)
    for c in range(C):
        assert np.array_equal(got[:, c][valid[:, c]], sent)


def test_two_kernel_path_takes_the_cached_advances():
    """``prod_rx_batch(fuse_frontend=False)`` takes its adv^b planes from
    ``ops.fused_rx._advances`` (uploaded once per config, B and device),
    not from a table built and copied per call, and its outputs and state
    are the one-kernel path's on the same frames."""
    tcfg = config_from_dict(dataclasses.asdict(BENCH))
    rng = np.random.default_rng(23)
    frames = torch.from_numpy(rng.integers(-16384, 16384, (3, 2,
                                                           CFG.frame_size),
                                           dtype=np.int16))
    frames[1, 0, 400:400 + 600] = 0                 # some silence too
    _advances.cache_clear()
    st = prod_rx_init_planes(tcfg, 2, "cpu")
    outs = []
    for _ in range(2):
        st, out = prod_rx_batch(tcfg, st, frames)
        outs.append((st, out))
    info = _advances.cache_info()
    assert info.misses == 1 and info.hits >= 1
    st = prod_rx_init_planes(tcfg, 2, "cpu")
    for st_two, out_two in outs:
        st, out = prod_rx_batch(tcfg, st, frames, fuse_frontend=True)
        for a, b in zip((*st_two, *out_two), (*st, *out)):
            assert torch.equal(a, b)
