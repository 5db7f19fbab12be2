"""Modem numerology: the JAX package's numpy-only ``ModemConfig``.

Re-exported so that both packages share one numerology; importing it
loads no JAX (``singlecarrier_tpu/__init__.py`` and ``config.py`` are
numpy-only).
"""

from singlecarrier_tpu.config import DEFAULT_CONFIG, ModemConfig

__all__ = ["ModemConfig", "DEFAULT_CONFIG"]
