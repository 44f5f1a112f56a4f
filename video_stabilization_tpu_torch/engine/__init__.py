"""The stabilization engine: carry, the one step body and its forms (the
per-frame step, offline chunks of one stream or of S), smoothing, modes,
checkpoints."""

from video_stabilization_tpu_torch.engine.checkpoint import (  # noqa: F401
    carry_from_numpy,
    carry_to_numpy,
    load_carry,
    save_carry,
)
from video_stabilization_tpu_torch.engine.lock import (  # noqa: F401
    LockResult,
    orb_lock,
    sift_lock,
)
from video_stabilization_tpu_torch.engine.offline import (  # noqa: F401
    frame_keys,
    make_offline_batched_fn,
    make_offline_fn,
    offline_batched_chunk_step,
    offline_chunk_step,
    stabilize_clip_offline,
)
from video_stabilization_tpu_torch.engine.smoothing import smoothing_homography  # noqa: F401
from video_stabilization_tpu_torch.engine.stabilizer import (  # noqa: F401
    Stabilizer,
    make_scan_fn,
    make_step_ext_fn,
    make_step_fn,
    make_track_fn,
    stabilize_step,
)
from video_stabilization_tpu_torch.engine.state import (  # noqa: F401
    EngineCarry,
    Sharded,
    carry_stream,
    init_carry,
    map_carry,
    unshard,
)
