"""PyTorch port against the JAX package on NOISY streams, on the CPU.

The other parity tests feed clean streams, where no soft value sits near
a decision boundary.  Here the JAX TX (scrambled, flushed gap) goes
through the JAX channel with AWGN and a 15 Hz carrier offset, cast to
int16, each channel delayed by its own offset:

  * at 4 dB, the reference numerology, 4 channels x 4 packets: the
    port's XLA path ``make_prod_rx_fn(batched=True)`` against the JAX
    package's;
  * at 12 dB, alt_9600 at its bench operating point (bf16 planes, int8
    hunt, ``ls_refit_symbols=128``), 2 channels x 3 packets: the port's
    one-kernel path ``prod_rx_batch(fuse_frontend=True)`` on CPU tensors
    (the kernels' plain versions) against one call of the JAX package's
    in interpret mode.

Held to the North star's criterion (identical valid flags, bits on valid
blocks, lag and phase on detected blocks, |dcfo| < 0.5 Hz, |deq_error|
< 2e-3) with ``matches`` equal; and both sides make the same bit errors
against the sent payload.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from singlecarrier_tpu.channel import channel as jchannel
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream as jtx_stream
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import rx_production as trx
from singlecarrier_tpu_torch.ops._build import NUMEROLOGIES


def _stream(cfg, channels, packets, snr_db, seed):
    """(sent bits [C, packets, bits_per_frame], [C, nb, n] int16)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (channels, packets, cfg.ns,
                               cfg.data_symbols * 2), dtype=np.uint8)
    x = np.asarray(jax.jit(lambda b: jchannel(
        jax.random.PRNGKey(seed),
        jtx_stream(cfg, b, scramble=True, flush_gap=True), snr_db=snr_db,
        freq_hz=15.0, fs=cfg.fs).astype(jnp.int16))(jnp.asarray(bits)))
    n = cfg.frame_size
    shifts = rng.integers(0, n, channels)
    nb = -(-(x.shape[1] + n) // n) + 1
    out = np.zeros((channels, nb * n), np.int16)
    for c, s in enumerate(shifts):
        out[c, s:s + x.shape[1]] = x[c]
    return (bits.reshape(channels, packets, -1),
            out.reshape(channels, nb, n))


def _err_bits(out, sent):
    """Bit errors of the valid blocks against the nearest sent packet of
    their channel; out leaves [C, nb, ...]."""
    errs = 0
    for c in range(sent.shape[0]):
        for b in out.bits[c][out.valid[c]]:
            errs += int((sent[c] != b).sum(axis=-1).min())
    return errs


def _agree(t, j, sent, min_valid):
    v = j.valid
    assert int(v.sum()) >= min_valid
    assert np.array_equal(t.valid, v)
    for name in ("bits", "lag", "timing_phase"):
        assert np.array_equal(getattr(t, name)[v], getattr(j, name)[v])
    assert np.array_equal(t.matches, j.matches)
    assert np.abs(t.cfo_hz[v] - j.cfo_hz[v]).max() < 0.5
    assert np.abs(t.eq_error[v] - j.eq_error[v]).max() < 2e-3
    assert _err_bits(t, sent) == _err_bits(j, sent)
    return _err_bits(j, sent)


def _np(out):
    return jax.tree.map(np.asarray, out)


def test_xla_path_matches_jax_at_4_db():
    sent, frames = _stream(CFG, 4, 4, 4.0, seed=41)
    _, oj = jrx.make_prod_rx_fn(CFG, batched=True, descramble=True)(
        jrx.prod_rx_init(CFG, (4,)), jnp.asarray(frames))
    tcfg = interop.config_from_dict(dataclasses.asdict(CFG))
    _, ot = trx.make_prod_rx_fn(tcfg, batched=True, descramble=True)(
        trx.prod_rx_init(tcfg, (4,), device="cpu"), torch.from_numpy(frames))
    errs = _agree(_np(ot), _np(oj), sent, min_valid=14)
    assert errs > 0                     # the noise reaches the decisions


def test_one_kernel_path_matches_jax_at_alt_9600():
    cfg = CFG.replace(**NUMEROLOGIES["alt_9600"], decim_dtype="bf16",
                      hunt_dtype="int8", ls_refit_symbols=128)
    sent, frames = _stream(cfg, 2, 3, 12.0, seed=42)
    C = frames.shape[0]
    batch = frames.transpose(1, 0, 2).copy()            # [B, C, n]
    _, oj = jrx.prod_rx_batch(
        cfg, jrx.prod_rx_init_planes(cfg, C), jnp.asarray(batch),
        descramble=True, block_channels=C, decode_block_channels=C,
        fuse_frontend=True, interpret=True)
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    _, ot = trx.prod_rx_batch(tcfg, trx.prod_rx_init_planes(tcfg, C, "cpu"),
                              torch.from_numpy(batch), descramble=True,
                              fuse_frontend=True)

    def per_channel(out):               # [B, C, ...] -> [C, B, ...]
        return type(out)(*(np.swapaxes(np.asarray(x), 0, 1) for x in out))

    _agree(per_channel(_np(ot)), per_channel(_np(oj)), sent, min_valid=5)
