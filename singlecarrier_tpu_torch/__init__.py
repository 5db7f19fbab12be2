"""singlecarrier_tpu_torch: the single-carrier QPSK modem in PyTorch.

A port of ``singlecarrier_tpu`` (JAX, Pallas on a TPU) to PyTorch with
CUDA kernels written by hand for an NVIDIA H100 (``sm_90a``).  The JAX
package is the reference and shares its numpy-only numerology
(``ModemConfig``) and constant tables with this package; nothing here
imports JAX.

Layer map:
  config, constants  re-exports of the shared numerology and tables
  dsp/               mixer table + FIR-tail carry-out, DFT table
  ops/               frontend_decim, hunt, extract_decode (CUDA kernels
                     in csrc/ with plain PyTorch twins); fused_rx_block
  modem/             prod_rx_batch (the one-kernel production RX path)
  interop            the JAX plane state <-> torch tensors
"""

from .config import DEFAULT_CONFIG, ModemConfig
from .modem import ProdRxOut, prod_rx_batch, prod_rx_init_planes

__all__ = ["ModemConfig", "DEFAULT_CONFIG", "ProdRxOut", "prod_rx_batch",
           "prod_rx_init_planes"]
