"""The runtime layer around the receiver (``singlecarrier_tpu.runtime``
counterpart): the streaming demodulator, checkpoint and resume, failover,
boundary validation, metrics and profiling; the sharded checkpoint
(``save_sharded`` / ``restore_sharded``, over
``torch.distributed.checkpoint``); ``runtime.engine`` (the
native PCM engine) and ``runtime.ingest`` (file -> pinned buffers ->
side-stream copies -> the kernel main path) are imported by name."""

from .stream import StreamDemodulator
from .checkpoint import (restore_sharded, restore_state, save_sharded,
                         save_state)
from .failover import (ElasticDemodulator, Heartbeat, failed_processes,
                       health_check, monitor_heartbeats)
from .metrics import MetricsAggregator
from .profiling import ThroughputMeter, log_compiles, trace
from .validate import assert_pcm_block, assert_rx_state, checkify_step

__all__ = [
    "assert_pcm_block",
    "assert_rx_state",
    "checkify_step",
    "StreamDemodulator",
    "save_state",
    "restore_state",
    "save_sharded",
    "restore_sharded",
    "ElasticDemodulator",
    "Heartbeat",
    "failed_processes",
    "health_check",
    "monitor_heartbeats",
    "MetricsAggregator",
    "ThroughputMeter",
    "log_compiles",
    "trace",
]
