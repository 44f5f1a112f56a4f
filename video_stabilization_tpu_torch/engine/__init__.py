"""The stabilization engine: carry, per-frame step, smoothing, modes."""

from video_stabilization_tpu_torch.engine.checkpoint import (  # noqa: F401
    carry_from_numpy,
    carry_to_numpy,
)
from video_stabilization_tpu_torch.engine.lock import (  # noqa: F401
    LockResult,
    orb_lock,
    sift_lock,
)
from video_stabilization_tpu_torch.engine.smoothing import smoothing_homography  # noqa: F401
from video_stabilization_tpu_torch.engine.stabilizer import (  # noqa: F401
    Stabilizer,
    frame_keys,
    stabilize_step,
)
from video_stabilization_tpu_torch.engine.state import EngineCarry, init_carry  # noqa: F401
