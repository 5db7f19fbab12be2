"""The TX, the faithful RX and the production RX of the port
(``singlecarrier_tpu.modem`` counterpart)."""

from .rx import (RxOut, RxState, make_rx_stream_fn, rx_frame, rx_init,
                 rx_stream)
from .rx_gated import GatedRxState, prod_rx_batch_gated, prod_rx_gated_init
from .rx_production import (ProdRxOut, ProdRxState, dibits_to_bits,
                            make_prod_rx_fn, planes_to_state, prod_rx_backend,
                            prod_rx_batch, prod_rx_frame, prod_rx_init,
                            prod_rx_init_planes, prod_rx_stream,
                            prod_rx_stream_pallas, prod_rx_stream_superstep,
                            state_to_planes)
from .tx import TxState, qpsk_demod, qpsk_mod, tx_init, tx_packet, tx_stream

__all__ = ["GatedRxState", "ProdRxOut", "ProdRxState", "TxState",
           "dibits_to_bits", "make_prod_rx_fn", "planes_to_state",
           "prod_rx_backend", "prod_rx_batch", "prod_rx_batch_gated",
           "prod_rx_frame", "prod_rx_gated_init", "prod_rx_init",
           "prod_rx_init_planes", "prod_rx_stream", "prod_rx_stream_pallas",
           "prod_rx_stream_superstep", "qpsk_demod", "qpsk_mod", "RxOut",
           "RxState", "make_rx_stream_fn", "rx_frame", "rx_init",
           "rx_stream", "state_to_planes", "tx_init", "tx_packet",
           "tx_stream"]
