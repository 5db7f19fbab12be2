"""PyTorch port at the ten retuned numerologies the JAX package's Pallas
paths run (``ops/_build.RETUNED_NUMEROLOGIES``): one and two correlation
segments (``corr_segments=1`` is the reference's coherent correlator),
a 16-, 128-, 1001-, 4096-, 8192- and 32768-bin CFO search, and 25- and
45-tap RRC filters.

For each, ``tests/test_torch_numerology.py``'s cases: its seeded TX stream
(two packets) on C = 2 channels, the second delayed by a third of a
block, descramble off, at the bench operating point:

  * the whole slice: the port's ``prod_rx_batch(fuse_frontend=True)`` on
    CPU tensors (the kernels' plain versions), the state carried across
    two calls, against one call of the JAX package's
    ``prod_rx_batch(fuse_frontend=True, interpret=True)``;
  * the XLA path: the port's ``prod_rx_stream`` against the JAX
    package's, one channel, the state carried across two calls on the
    port's side.

Both held to the North star's criterion (identical valid flags, bits on
valid blocks, lag, phase and matches on detected blocks, |dcfo| < 0.5 Hz,
|deq_error| < 2e-3), every sent packet found with its bits.

And one case per launcher that each limit reaches, as in
``tests/test_torch_numerology_kernels.py``, with its inputs and
tolerances: at ``seg1`` the hunt with the extraction and decode (the int8
peak of 128-chip segments); at ``nfft4096`` the two decode launchers on
the padded windows and on the packets; at ``taps45`` (a 44-sample halo)
the per-row front-end in both layouts and the full-rate front-end; at
``nfft1001`` (rows of the DFT table no multiple of 4 floats, ragged bin
groups and lanes) and ``nfft32768`` (the limit, past 1024 bins the
running first maximum) the two decode launchers again.  ``seg1`` and the
DFT sizes share the reference's front-end, so one JAX run of it serves
them all.
"""

import pytest

from singlecarrier_tpu_torch.ops._build import RETUNED_NUMEROLOGIES

import test_torch_numerology as whole
import test_torch_numerology_kernels as launchers

NAMES = RETUNED_NUMEROLOGIES


@pytest.mark.parametrize("name", NAMES)
def test_one_kernel_batch_path_matches_jax(name):
    whole.test_one_kernel_batch_path_matches_jax(name)


@pytest.mark.parametrize("name", NAMES)
def test_xla_path_matches_jax(name):
    whole.test_xla_path_matches_jax(name)


def test_hunt_and_extract_decode_match_jax_at_one_segment():
    launchers.test_hunt_and_extract_decode_match_jax("seg1")


def test_decode_launchers_match_jax_at_4096_bins():
    launchers.test_decode_launchers_match_jax("nfft4096")


@pytest.mark.parametrize("name", ["nfft1001", "nfft32768"])
def test_decode_launchers_match_jax_at_other_dft_sizes(name):
    launchers.test_decode_launchers_match_jax(name)


def test_frontend_rows_match_jax_at_45_taps():
    launchers.test_frontend_rows_match_jax("taps45")


def test_frontend_full_matches_jax_at_45_taps():
    launchers.test_frontend_full_matches_jax("taps45")
