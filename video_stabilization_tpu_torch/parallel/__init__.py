"""Multi-stream execution: a stream dimension on one card."""

from video_stabilization_tpu_torch.engine.state import carry_stream  # noqa: F401
from video_stabilization_tpu_torch.parallel.streams import (  # noqa: F401
    STREAM_AXIS,
    init_batched_carry,
    make_batched_scan_fn,
    make_batched_step_fn,
    make_sharded_offline_fn,
    make_sharded_step_fn,
    make_stream_mesh,
    shard_carry,
)
