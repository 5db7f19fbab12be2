"""PyTorch port at the numerologies the JAX package runs beyond the
reference one (``ops/_build.NUMEROLOGIES``: 9.6 kHz / 2400 Bd, a 2-, a
72- and a 124-symbol payload, 7 equalizer taps, 4 and 16 correlation
segments, a 1024-bin CFO search).

For each, the seeded TX stream of ``tests/test_alt_numerology.py``
(two packets, flushed gap) on C = 2 channels, the second delayed by a
third of a block, descramble off, at the bench operating point (bf16
planes, int8 hunt, ``ls_refit_symbols = min(128, D)``):

  * the whole slice: the port's ``prod_rx_batch(fuse_frontend=True)``
    on CPU tensors (the kernels' plain versions), the state carried
    across two calls, against one call of the JAX package's
    ``prod_rx_batch(fuse_frontend=True, interpret=True)``;
  * the XLA path: the port's ``prod_rx_stream`` against the JAX
    package's, one channel, the state carried across two calls on the
    port's side.

Held to the North star's criterion: identical valid flags, bits on valid
blocks, lag and phase on detected blocks, |dcfo| < 0.5 Hz, |deq_error|
< 2e-3; and every sent packet found with its bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu_torch.interop import config_from_dict
from singlecarrier_tpu_torch.modem import (prod_rx_batch, prod_rx_init,
                                           prod_rx_init_planes,
                                           prod_rx_stream)
from singlecarrier_tpu_torch.ops._build import (LONG_NUMEROLOGIES,
                                                NUMEROLOGIES,
                                                RETUNED_NUMEROLOGIES,
                                                WIDE_NUMEROLOGIES)

C = 2
N_PACKETS = 2
# the eight numerologies of at most 7 equalizer taps, 5 cycles and 376
# symbols a block at 4-16 segments, 256-1024 bins and 49 taps; the seven
# wider ones are test_torch_numerology_wide.py's, the six retuned ones
# test_torch_numerology_limits.py's, the five long ones
# test_torch_numerology_long.py's
NAMES = sorted(set(NUMEROLOGIES) - set(WIDE_NUMEROLOGIES)
               - set(RETUNED_NUMEROLOGIES) - set(LONG_NUMEROLOGIES))


def _bench(name):
    cfg = CFG.replace(**NUMEROLOGIES[name])
    return cfg.replace(decim_dtype="bf16", hunt_dtype="int8",
                       ls_refit_symbols=min(128, cfg.frame_symbols))


def _stream(cfg, seed=3):
    """(bits, [C, samples] int16): ``_roundtrip_frames``' TX stream on
    channel 0 and delayed by a third of a block on channel 1."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (N_PACKETS, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True))
    n = cfg.frame_size
    nb = -(-(len(pcm) + n // 3) // n)
    x = np.zeros((C, nb * n), np.int16)
    for c, d in enumerate((0, n // 3)):
        x[c, d:d + len(pcm)] = pcm
    return bits.reshape(N_PACKETS, -1), x


def _agree(got, want, bits):
    """The North star's criterion of the port's outputs ``got`` against
    the JAX package's ``want`` (numpy, same layout), and the truth."""
    v = want.valid
    assert np.array_equal(got.valid, v)
    assert int(v.sum()) == N_PACKETS * (C if v.ndim > 1 else 1)
    for name in ("bits", "lag", "timing_phase", "matches"):
        assert np.array_equal(getattr(got, name)[v], getattr(want, name)[v])
    assert np.abs(got.cfo_hz[v] - want.cfo_hz[v]).max() < 0.5
    assert np.abs(got.eq_error[v] - want.eq_error[v]).max() < 2e-3
    sent = {tuple(b) for b in bits}
    assert {tuple(b) for b in want.bits[v]} == sent


def _np(out):
    return jax.tree.map(np.asarray, out)


def _cat(parts):
    return type(parts[0])(*(torch.cat(v).numpy() for v in zip(*parts)))


def _frames(cfg, x):
    """The [B, C, n] blocks of a [C, samples] stream."""
    return x.reshape(C, -1, cfg.frame_size).transpose(1, 0, 2).copy()


def _jax_batch(cfg, frames):
    """The JAX package's one-kernel batch path (interpret mode), one call,
    numpy."""
    _, out = jrx.prod_rx_batch(
        cfg, jrx.prod_rx_init_planes(cfg, C), jnp.asarray(frames),
        descramble=False, block_channels=C, decode_block_channels=C,
        fuse_frontend=True, interpret=True)
    return _np(out)


def _port_batch(cfg, frames):
    """The port's ``prod_rx_batch(fuse_frontend=True)`` on CPU tensors,
    the state carried across two calls, numpy."""
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    state = prod_rx_init_planes(tcfg, C, "cpu")
    half = frames.shape[0] // 2
    parts = []
    for part in (frames[:half], frames[half:]):
        state, out = prod_rx_batch(tcfg, state, torch.from_numpy(part),
                                   descramble=False, fuse_frontend=True)
        parts.append(out)
    assert state[4].dtype == torch.bfloat16
    assert tuple(state[4].shape) == (cfg.cycles, 2, C,
                                     cfg.symbols_per_block)
    return _cat(parts)


@pytest.mark.parametrize("name", NAMES)
def test_one_kernel_batch_path_matches_jax(name):
    cfg = _bench(name)
    bits, x = _stream(cfg)
    frames = _frames(cfg, x)
    _agree(_port_batch(cfg, frames), _jax_batch(cfg, frames), bits)


@pytest.mark.parametrize("name", NAMES)
def test_xla_path_matches_jax(name):
    cfg = _bench(name)
    bits, x = _stream(cfg)
    frames = x[1].reshape(-1, cfg.frame_size)
    _agree(_port_stream(cfg, frames), _jax_stream(cfg, frames), bits)


def _jax_stream(cfg, frames):
    """The JAX package's XLA path on one channel's [B, n] blocks, numpy."""
    _, out = jrx.prod_rx_stream(cfg, jrx.prod_rx_init(cfg),
                                jnp.asarray(frames), descramble=False)
    return _np(out)


def _port_stream(cfg, frames):
    """The port's XLA path on one channel's [B, n] blocks, the state
    carried across two calls, numpy."""
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    state = prod_rx_init(tcfg, device="cpu")
    half = frames.shape[0] // 2
    parts = []
    for part in (frames[:half], frames[half:]):
        state, out = prod_rx_stream(tcfg, state, torch.from_numpy(part),
                                    descramble=False)
        parts.append(out)
    return _cat(parts)
