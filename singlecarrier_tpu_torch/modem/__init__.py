"""Production RX of the port (``singlecarrier_tpu.modem`` counterpart)."""

from .rx_production import (ProdRxOut, dibits_to_bits, prod_rx_batch,
                            prod_rx_init_planes)

__all__ = ["ProdRxOut", "dibits_to_bits", "prod_rx_batch",
           "prod_rx_init_planes"]
