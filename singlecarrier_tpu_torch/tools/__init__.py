"""Measuring and checking tools of the port, each run on the card as
``python3 -m singlecarrier_tpu_torch.tools.<name>``:

  parity              every kernel path held to the XLA path on the parity
                      records' impaired stream: ``PARITY_GPU*.json``;
  detection           false-alarm (Pfa) and detection (Pd) rates of the
                      detector over gates: ``DETECTION_GPU.json``, ``.md``;
  roofline            every CUDA kernel's time beside its bound:
                      ``ROOFLINE_GPU.md``;
  profile_stages      cumulative stage prefixes of the RX paths;
  gated_decode_bench  the gated RX's constituents and break-even density:
                      ``GATED_DECODE_GPU.json``;
  gated_wrapper_bench ``prod_rx_batch_gated`` against the full path:
                      ``GATED_WRAPPER_GPU.json``;
  ingest_bench        file -> host assembly -> H2D -> main path:
                      ``BENCH_INGEST_GPU.json``;
  scaling_bench       the same work unpartitioned and partitioned on one
                      card: ``SCALING_GPU.md``.

``_measure`` holds what they share with ``chip_smoke.py`` and
``kernel_ab``: the card's peaks and the kernels' bounds, CUDA-event
timers and the kernels' seeded operands.  Every tool takes its device
from ``device.resolve_device`` and raises without a card; the timing
tools also refuse ``--device cpu``.
"""
