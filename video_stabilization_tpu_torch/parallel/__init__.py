"""Multi-stream execution: a stream dimension, sharded over a mesh of devices."""

from video_stabilization_tpu_torch.engine.state import Sharded, carry_stream, unshard  # noqa: F401
from video_stabilization_tpu_torch.parallel.streams import (  # noqa: F401
    STREAM_AXIS,
    batched_counters,
    init_batched_carry,
    init_sharded_carry,
    make_batched_scan_fn,
    make_batched_step_fn,
    make_sharded_offline_fn,
    make_sharded_step_fn,
    make_stream_mesh,
    reset_batched_counters,
    set_stream_mode,
    shard_carry,
    split_streams,
)
