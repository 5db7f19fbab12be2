"""PyTorch port, end to end: ``prod_rx_batch(fuse_frontend=False)``.

The port runs the same int16 streams as the JAX package's two-kernel
batch path (Pallas kernels in interpret mode, C = 4) in its three legal
flag combinations -- ``fuse_hunt=True`` (kernels #3 and #5),
``fuse_hunt=False`` (#3, the plain hunt, #6) and ``fuse_extract=False``
(#3, the plain hunt and extraction, #7) -- at the bench operating point
and the library default, with the dispatch split in two calls.  The
port's first call starts from the JAX initial state and its second from
the JAX state after the first call, carried through ``interop``, so
each call is compared from the same state.

Tolerances: decisions by ``tools/tpu_parity.py``'s criterion (identical
valid, bits on valid rows, lag and phase on detected rows, |dcfo| <
0.5 Hz, |deq_error| < 2e-3); the carried phase and tail to 1e-6; the
carried decim planes to one bf16 ulp where they were stored in bf16,
else to the f32 reassociation of the 49-term filter sum (< 2e-5).
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
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (ProdRxState, prod_rx_batch,
                                           prod_rx_init,
                                           prod_rx_init_planes,
                                           state_to_planes)

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
CONFIGS = {"bench": BENCH, "default": CFG}
PATHS = {"fused": dict(fuse_hunt=True, fuse_extract=True),
         "xhunt": dict(fuse_hunt=False, fuse_extract=True),
         "unfused": dict(fuse_hunt=False, fuse_extract=False)}
C = 4
GOLDEN_DELAYS = (0, 3, 377, 1879)


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


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


def _run_both(cfg, frames, descramble, flags):
    half = frames.shape[0] // 2
    tcfg = _tcfg(cfg)
    st_j = jrx.prod_rx_init(cfg, (C,))
    outs_j, outs_t, states = [], [], []
    for part in (frames[:half], frames[half:]):
        st_t = interop.state_from_numpy([np.asarray(a) for a in st_j],
                                        device="cpu")
        st_j, o_j = jrx.prod_rx_batch(
            cfg, st_j, jnp.asarray(part), descramble=descramble,
            block_channels=C, decode_block_channels=C, interpret=True,
            **flags)
        st_t, o_t = prod_rx_batch(tcfg, st_t, torch.from_numpy(part),
                                  descramble=descramble, **flags)
        assert isinstance(st_t, ProdRxState)
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
        assert np.allclose(o_t.peak.numpy()[v], o_j.peak[v], rtol=1e-5)


def _assert_state_close(st_j, st_t, bf16_planes):
    for a, b in zip(st_j[:2], st_t[:2]):
        assert b.dtype == torch.complex64
        assert np.abs(a - b.numpy()).max() <= 1e-6
    dj, dt = st_j[2], st_t[2].numpy()
    for pj, pt in ((dj.real, dt.real), (dj.imag, dt.imag)):
        err = np.abs(pj - pt)
        if bf16_planes:
            _, e = np.frexp(np.maximum(np.abs(pj), 1e-30))
            assert np.all(err <= np.ldexp(1.0, e - 8))
        else:
            assert err.max() < 2e-5


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_stream_matches_jax_and_decodes(name, path, golden):
    cfg = CONFIGS[name]
    frames = _golden_frames(golden)
    outs_j, outs_t, states = _run_both(cfg, frames, False, PATHS[path])
    for o_t, o_j in zip(outs_t, outs_j):
        _assert_parity(o_t, o_j)
    bf16 = cfg.decim_dtype == "bf16" and path == "fused"
    for st_j, st_t in states:
        _assert_state_close(st_j, st_t, bf16)
    valid = torch.cat([o.valid for o in outs_t]).numpy()
    bits = torch.cat([o.bits for o in outs_t]).numpy()
    ref = golden["tx_bits"].reshape(10, CFG.bits_per_frame)
    for c in range(C):
        got = bits[:, c][valid[:, c]]
        assert got.shape == ref.shape          # 10/10 packets
        # exact except the TX-truncated tail (last 5 symbols = 10 bits)
        assert np.array_equal(got[:, :-10], ref[:, :-10])


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_noisy_random_stream_matches_jax_and_decodes(name, path):
    cfg = CONFIGS[name]
    frames, bits = _awgn_frames()
    outs_j, outs_t, states = _run_both(cfg, frames, True, PATHS[path])
    for o_t, o_j in zip(outs_t, outs_j):
        _assert_parity(o_t, o_j)
    bf16 = cfg.decim_dtype == "bf16" and path == "fused"
    for st_j, st_t in states:
        _assert_state_close(st_j, st_t, bf16)
    valid = torch.cat([o.valid for o in outs_t]).numpy()
    got = torch.cat([o.bits for o in outs_t]).numpy()
    sent = bits.reshape(3, CFG.bits_per_frame)
    for c in range(C):
        assert np.array_equal(got[:, c][valid[:, c]], sent)


@pytest.mark.parametrize("fuse_frontend", [False, True],
                         ids=["two-kernel", "one-kernel"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plane_state_and_complex_state_give_the_same_decisions(
        name, fuse_frontend, golden):
    """The state's type changes no decision, and each type comes back;
    the round trip through the complex state is exact (bf16 planes
    widen to f32 and round back unchanged)."""
    tcfg = _tcfg(CONFIGS[name])
    frames = torch.from_numpy(_golden_frames(golden)[:6])
    st_p, o_p = prod_rx_batch(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                              frames, fuse_frontend=fuse_frontend)
    st_c, o_c = prod_rx_batch(tcfg, prod_rx_init(tcfg, (C,), "cpu"),
                              frames, fuse_frontend=fuse_frontend)
    assert isinstance(st_c, ProdRxState) and isinstance(st_p, tuple)
    assert bool(o_p.valid.any())
    for a, b in zip(o_p, o_c):
        assert torch.equal(a, b)
    for a, b in zip(st_p, state_to_planes(tcfg, st_c)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_plane_state_on_an_unfused_path_raises():
    tcfg = _tcfg(CFG)
    state = prod_rx_init_planes(tcfg, C, "cpu")
    pcm = torch.zeros((2, C, CFG.frame_size), dtype=torch.int16)
    for flags in (PATHS["xhunt"], PATHS["unfused"]):
        with pytest.raises(TypeError, match="ProdRxState"):
            prod_rx_batch(tcfg, state, pcm, **flags)
    with pytest.raises(ValueError, match="fuse_frontend requires"):
        prod_rx_batch(tcfg, prod_rx_init(tcfg, (C,), "cpu"), pcm,
                      fuse_frontend=True, fuse_hunt=False)
