"""Production RX of the port (``singlecarrier_tpu.modem`` counterpart)."""

from .rx_gated import GatedRxState, prod_rx_batch_gated, prod_rx_gated_init
from .rx_production import (ProdRxOut, ProdRxState, dibits_to_bits,
                            make_prod_rx_fn, planes_to_state, prod_rx_batch,
                            prod_rx_init, prod_rx_init_planes,
                            prod_rx_stream_pallas, prod_rx_stream_superstep,
                            state_to_planes)

__all__ = ["GatedRxState", "ProdRxOut", "ProdRxState", "dibits_to_bits",
           "make_prod_rx_fn", "planes_to_state", "prod_rx_batch",
           "prod_rx_batch_gated", "prod_rx_gated_init", "prod_rx_init",
           "prod_rx_init_planes", "prod_rx_stream_pallas",
           "prod_rx_stream_superstep", "state_to_planes"]
