"""singlecarrier_tpu_torch: the single-carrier QPSK modem in PyTorch.

A port of ``singlecarrier_tpu`` (JAX, Pallas on a TPU) to PyTorch with
CUDA kernels written by hand for an NVIDIA H100 (``sm_90a``).  The JAX
package is the reference; this package imports nothing of it and
nothing of JAX, and keeps its own copies of the numerology
(``ModemConfig``), the constant tables and the filter designer.

The device rule: state constructors (``rx_init``, ``prod_rx_init``,
``prod_rx_init_planes``, ``tx_init``), ``tx_stream``, ``channel``,
``ber_run``, the CLI and ``interop.*_from_numpy`` make their tensors on
the card unless the caller passes ``device`` (``"cpu"`` in the tests)
and raise where there is no card; the processing entry points run on
the device their state lies on and move the PCM there.
A kernel wrapper takes its plain PyTorch version only for tensors that
lie on the CPU; for a CUDA tensor it launches its kernel or raises.

Layer map:
  config, constants, filter_design  numerology, tables, RRC designer
  device             the device rule (``resolve_device``), the TF32
                     guard, XLA's saturating int16 cast (``to_int16``)
  dsp/               mixer (table, ``mix_block``, FIR-tail carry-out),
                     banded/direct FIR, decimator, preamble correlator,
                     the CFO search and DFT table
  utils/, adaptive/  unrolled Cholesky; the square-root Kalman and its
                     equalizer steps, the blocked RLS; the LS equalizer
                     and refinement
  scramble           DVB keystream XOR
  ops/               frontend_decim, fused_frontend_decim (both also
                     mixer-folded), fused_frontend, hunt, extract_decode,
                     extract_gate, fused_hunt_decode_decim,
                     fused_decode_extract, fused_decode (CUDA kernels in
                     csrc/ beside plain PyTorch versions); fused_rx_block
  modem/             the faithful RX (rx_frame, rx_stream,
                     make_rx_stream_fn, RxState: the C reference's
                     chain, plain PyTorch); the XLA path (prod_rx_frame,
                     prod_rx_stream, prod_rx_backend: plain PyTorch, the
                     oracle), prod_rx_batch, prod_rx_stream_pallas,
                     prod_rx_stream_superstep, ProdRxState and the plane
                     state; prod_rx_batch_gated and GatedRxState; the TX
  runtime/           StreamDemodulator, the native PCM engine and the
                     ingest (pinned buffers, side-stream copies into the
                     main path), checkpoint and resume (also sharded, over
                     torch.distributed.checkpoint), failover, boundary
                     checks, metrics, profiling
  parallel/          the multi-device layer over torch.distributed: the
                     (ch, time) DeviceMesh, channel-sharded RX (the XLA
                     path and the kernel paths), time- and grid-sharded RX
                     with a one-block halo exchange, the metric
                     all-reduce, the multi-process launcher (multihost)
  channel, ber       impairments; BER sweeps over the three RX paths
  cli, __main__      ``python -m singlecarrier_tpu_torch info|mod|demod|
                     loopback|ber``
  interop            configs and RX states across the two packages
"""

from .config import DEFAULT_CONFIG, ModemConfig
from .modem import (GatedRxState, ProdRxOut, ProdRxState, RxOut, RxState,
                    make_prod_rx_fn, make_rx_stream_fn, planes_to_state,
                    prod_rx_batch, prod_rx_batch_gated, prod_rx_frame,
                    prod_rx_gated_init, prod_rx_init, prod_rx_init_planes,
                    prod_rx_stream, prod_rx_stream_pallas,
                    prod_rx_stream_superstep, rx_frame, rx_init, rx_stream,
                    state_to_planes, tx_stream)

__all__ = ["ModemConfig", "DEFAULT_CONFIG", "GatedRxState", "ProdRxOut",
           "ProdRxState", "RxOut", "RxState", "make_prod_rx_fn",
           "make_rx_stream_fn", "planes_to_state", "prod_rx_batch",
           "prod_rx_batch_gated", "prod_rx_frame", "prod_rx_gated_init",
           "prod_rx_init", "prod_rx_init_planes", "prod_rx_stream",
           "prod_rx_stream_pallas", "prod_rx_stream_superstep", "rx_frame",
           "rx_init", "rx_stream", "state_to_planes", "tx_stream"]
