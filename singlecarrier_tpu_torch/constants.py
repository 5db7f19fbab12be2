"""Modem constant tables, shared with the JAX package (numpy-only)."""

from singlecarrier_tpu.constants import (PREAMBLE_VALUES, rrc_taps,
                                         scramble_dibit_mask)

__all__ = ["PREAMBLE_VALUES", "rrc_taps", "scramble_dibit_mask"]
