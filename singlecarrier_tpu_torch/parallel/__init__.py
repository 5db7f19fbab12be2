"""The multi-device layer (``singlecarrier_tpu.parallel`` counterpart)
over ``torch.distributed``: one process per card, a ``DeviceMesh`` of
shape (ch, time); ``parallel.multihost`` (the launcher) is imported by
name."""

from .mesh import device_count, make_mesh
from .sharded_rx import (make_channel_sharded_rx,
                         make_fused_grid_sharded_rx,
                         make_fused_sharded_rx,
                         metrics_summary, shard_channel_state,
                         shard_plane_state)
from .timeshard import (grid_sharded_rx, make_grid_sharded_rx,
                        make_time_sharded_rx, time_sharded_rx)

__all__ = [
    "make_mesh",
    "device_count",
    "make_channel_sharded_rx",
    "make_fused_grid_sharded_rx",
    "make_fused_sharded_rx",
    "metrics_summary",
    "shard_channel_state",
    "shard_plane_state",
    "time_sharded_rx",
    "make_time_sharded_rx",
    "grid_sharded_rx",
    "make_grid_sharded_rx",
]
