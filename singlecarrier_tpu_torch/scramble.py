"""DVB additive bit scrambler (``singlecarrier_tpu/scramble.py``).

The reference scrambles two bits per call through a 15-bit LFSR
(src/scramble.c:57-68).  The LFSR is autonomous, so scrambling is an XOR
with a fixed periodic keystream: a table lookup at an offset, batched
over channels.  Scramble and descramble are the same operation.  State
per stream is one integer offset into the keystream.
"""

from __future__ import annotations

import torch

from .constants import (SCRAMBLE_PERIOD, scramble_dibit_mask,
                        scramble_keystream)
from .device import on_device


def dibit_masks(offset, count: int, *, seed: int = 0x4A80,
                device=None) -> torch.Tensor:
    """XOR masks (u8) for ``count`` dibits from keystream ``offset``
    (in dibits, 2 LFSR steps each; an int or an int tensor of per-stream
    offsets [...], giving [..., count]); wraps at the period."""
    if device is None:
        device = offset.device if torch.is_tensor(offset) else "cpu"
    table = on_device(scramble_dibit_mask, (seed,), torch.device(device))
    idx = torch.as_tensor(offset, device=table.device)[..., None] \
        + torch.arange(count, device=table.device)
    return table[idx % SCRAMBLE_PERIOD]


def scramble_dibits(dibits: torch.Tensor, offset, *, seed: int = 0x4A80):
    """(De)scramble dibits [..., count]; returns ``(out, new_offset)``, as
    ``scramble(&dibit, reg)`` applied ``count`` times
    (src/scramble.c:74-84)."""
    count = dibits.shape[-1]
    masks = dibit_masks(offset, count, seed=seed, device=dibits.device)
    return (torch.bitwise_xor(dibits, masks.to(dibits.dtype)),
            (offset + count) % SCRAMBLE_PERIOD)


def scramble_bits(bits: torch.Tensor, offset_bits, *, seed: int = 0x4A80):
    """(De)scramble a bit array [..., n] at a bit-granular keystream
    offset; returns ``(out, new_offset)``."""
    table = on_device(scramble_keystream, (seed,), bits.device)
    n = bits.shape[-1]
    period = table.shape[0]
    idx = (torch.as_tensor(offset_bits, device=bits.device)[..., None]
           + torch.arange(n, device=bits.device)) % period
    return (torch.bitwise_xor(bits, table[idx].to(bits.dtype)),
            (offset_bits + n) % period)


def reference_lfsr_state(offset_dibits: int, *, seed: int = 0x4A80) -> int:
    """The C register content after ``offset_dibits`` dibits (debug aid)."""
    mem = seed
    for _ in range(2 * offset_dibits):
        o = ((mem >> 1) & 1) ^ (mem & 1)
        mem = (mem >> 1) | (o << 14)
    return mem


__all__ = ["dibit_masks", "scramble_dibits", "scramble_bits",
           "reference_lfsr_state", "SCRAMBLE_PERIOD"]
