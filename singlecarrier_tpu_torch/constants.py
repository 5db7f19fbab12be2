"""Modem constant tables (the port's own copy of
``singlecarrier_tpu/constants.py``; ``tests/test_torch_interop.py``
holds the tables equal).

The equivalent of the reference's ``src/constants.c``: the
128-chip PN preamble (constants.c:25-42) is transcribed as data; the
two 49-tap RRC tables (constants.c:49-99, 106-156) are *regenerated*
from the filter designer (filter_design.py) rather than pasted, and
golden-compared against the C tables in tests.  The DVB scrambler
keystream (src/scramble.c:57-68) is data-independent, so it is
precomputed here once as a bit array -- descrambling is then a
vectorized XOR, no sequential LFSR loop.
"""

from __future__ import annotations

import functools

import numpy as np

from .filter_design import reference_taps

# ---------------------------------------------------------------------------
# 128-chip BPSK PN preamble (reference: src/constants.c:25-42).
# ---------------------------------------------------------------------------
PREAMBLE_VALUES = np.array([
    -1, 1, 1, -1, -1, 1, 1, 1,
    -1, 1, -1, -1, 1, 1, -1, -1,
    1, 1, -1, 1, -1, -1, 1, -1,
    1, -1, 1, -1, 1, -1, 1, 1,
    1, -1, 1, 1, 1, 1, -1, -1,
    1, -1, -1, 1, 1, -1, 1, -1,
    1, 1, -1, 1, -1, -1, 1, -1,
    -1, -1, -1, 1, 1, -1, 1, -1,
    1, 1, 1, -1, -1, 1, 1, -1,
    1, 1, -1, -1, 1, 1, -1, 1,
    1, -1, 1, 1, -1, -1, -1, 1,
    -1, 1, -1, 1, -1, -1, -1, 1,
    -1, -1, 1, -1, 1, 1, -1, -1,
    -1, -1, -1, 1, 1, 1, -1, 1,
    1, -1, 1, 1, -1, -1, 1, 1,
    -1, 1, -1, 1, -1, -1, -1, 1,
], dtype=np.int8)

# Complex preamble table as the modem builds it: val + val*j, i.e. every
# chip sits on the 45-degree diagonal (reference: src/qpsk.c:361-365).
PREAMBLE_TABLE = (PREAMBLE_VALUES.astype(np.float32)
                  + 1j * PREAMBLE_VALUES.astype(np.float32)).astype(np.complex64)

# ---------------------------------------------------------------------------
# Gray-coded QPSK constellation (reference: src/constants.c:11-16 -- unused
# there; kept for API parity) and the mapping actually used by qpsk_mod
# (src/qpsk.c:251-256): bit=1 -> -1, bit=0 -> +1, dibit = (I<<1)|Q,
# symbol = I + jQ.
# ---------------------------------------------------------------------------
CONSTELLATION = np.array([1.0, 1.0j, -1.0j, -1.0], dtype=np.complex64)

# symbol for dibit d = (I_bit<<1)|Q_bit  (qpsk.c:251-256)
QPSK_SYMBOLS = np.array(
    [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], dtype=np.complex64
)

# ---------------------------------------------------------------------------
# RRC root filters, regenerated (reference tables: src/constants.c:49-156).
# alpha50 = "wide" (firwide=true), alpha35 = "narrow" (the default,
# src/qpsk.c:60).
# ---------------------------------------------------------------------------
ALPHA50_ROOT = reference_taps(0.50).astype(np.float32)
ALPHA35_ROOT = reference_taps(0.35).astype(np.float32)


@functools.lru_cache(maxsize=8)
def rrc_taps(alpha: float, ntaps: int = 49) -> np.ndarray:
    """RRC taps for an arbitrary roll-off (float32)."""
    return reference_taps(alpha, ntaps).astype(np.float32)


# ---------------------------------------------------------------------------
# DVB additive scrambler keystream (reference: src/scramble.c).
#
# LFSR: 15-bit register, polynomial 1 + X^14 + X^15, seed 0x4A80
# (scramble.h:16).  Each step: out = bit14 XOR bit15 (the two LSBs of the
# register as stored, scramble.c:59), register >>= 1, out reinserted at
# bit 15 (scramble.c:66-67).  The feedback depends only on the register,
# never the data, so the keystream is a fixed periodic bit sequence: we
# precompute one full period and descramble by XOR at an offset.
# ---------------------------------------------------------------------------
SCRAMBLE_PERIOD = (1 << 15) - 1  # maximal-length: 32767


@functools.lru_cache(maxsize=4)
def scramble_keystream(seed: int = 0x4A80,
                       length: int = SCRAMBLE_PERIOD) -> np.ndarray:
    """Keystream bits out[0..length-1] of the DVB LFSR from ``seed``.

    out[n] is the bit XORed with the n-th data bit processed
    (scramble.c:59-60); two bits are consumed per dibit (scramble.h:17).
    """
    mem = seed
    out = np.empty(length, dtype=np.uint8)
    for n in range(length):
        o = ((mem >> 1) & 1) ^ (mem & 1)
        out[n] = o
        mem = (mem >> 1) | (o << 14)
    return out


@functools.lru_cache(maxsize=4)
def scramble_dibit_mask(seed: int = 0x4A80,
                        length: int = SCRAMBLE_PERIOD) -> np.ndarray:
    """Per-dibit XOR masks: mask[k] applied to the k-th dibit.

    scramble() consumes keystream bit 2k for the Q bit (input bit 0) and
    bit 2k+1 for the I bit (input bit 1) of dibit k (scramble.c:57-68),
    so mask = (ks[2k+1] << 1) | ks[2k].
    """
    ks = scramble_keystream(seed, 2 * length)
    return ((ks[1::2] << 1) | ks[0::2]).astype(np.uint8)
