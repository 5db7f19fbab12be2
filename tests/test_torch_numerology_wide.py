"""PyTorch port at the seven widest numerologies the JAX CLI reaches
(``ops/_build.WIDE_NUMEROLOGIES``): 9 and 16 equalizer taps, 6 and 10
cycles a symbol (9.6 and 16 kHz at 1600 Bd), 9 and 16 data frames a
packet (407 and 624 symbols a block), and all of 16 taps, 16 frames and
16 kHz at once (``wide_corner``: 6240 samples a block, a 640-symbol
packet window).

For each, ``tests/test_torch_numerology.py``'s case: its seeded TX stream
(two packets) on C = 2 channels, the second delayed by a third of a
block, descramble off, at the bench operating point; the port's
``prod_rx_batch(fuse_frontend=True)`` on CPU tensors (the kernels' plain
versions), the state carried across two calls, against one call of the
JAX package's ``prod_rx_batch(fuse_frontend=True, interpret=True)``, by
the North star's criterion (identical valid flags, bits on valid
blocks, lag, phase and matches on detected blocks, |dcfo| < 0.5 Hz,
|deq_error| < 2e-3), every sent packet found with its bits.

At ``wide_corner`` only, one case per launcher as in
``tests/test_torch_numerology_kernels.py``, with its inputs and
tolerances: the per-row front-end (both layouts), the full-rate
front-end, the hunt with the extraction and decode, and the two decode
launchers on the padded windows and on the packets.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch.interop import config_from_dict
from singlecarrier_tpu_torch.modem import prod_rx_batch, prod_rx_init_planes
from singlecarrier_tpu_torch.ops._build import WIDE_NUMEROLOGIES

import test_torch_numerology as whole
import test_torch_numerology_kernels as launchers

C = whole.C
CORNER = "wide_corner"


@pytest.mark.parametrize("name", WIDE_NUMEROLOGIES)
def test_one_kernel_batch_path_matches_jax(name):
    cfg = whole._bench(name)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    bits, x = whole._stream(cfg)
    n = cfg.frame_size
    frames = x.reshape(C, -1, n).transpose(1, 0, 2).copy()  # [B, C, n]
    _, want = jrx.prod_rx_batch(
        cfg, jrx.prod_rx_init_planes(cfg, C), jnp.asarray(frames),
        descramble=False, block_channels=C, decode_block_channels=C,
        fuse_frontend=True, interpret=True)
    state = prod_rx_init_planes(tcfg, C, "cpu")
    half = frames.shape[0] // 2
    parts = []
    for part in (frames[:half], frames[half:]):
        state, out = prod_rx_batch(tcfg, state, torch.from_numpy(part),
                                   descramble=False, fuse_frontend=True)
        parts.append(out)
    assert tuple(state[4].shape) == (cfg.cycles, 2, C,
                                     cfg.symbols_per_block)
    whole._agree(whole._cat(parts), whole._np(want), bits)


def test_frontend_rows_match_jax_at_the_corner():
    launchers.test_frontend_rows_match_jax(CORNER)


def test_frontend_full_matches_jax_at_the_corner():
    launchers.test_frontend_full_matches_jax(CORNER)


def test_hunt_and_extract_decode_match_jax_at_the_corner():
    launchers.test_hunt_and_extract_decode_match_jax(CORNER)


def test_decode_launchers_match_jax_at_the_corner():
    launchers.test_decode_launchers_match_jax(CORNER)

