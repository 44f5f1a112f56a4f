"""Motion-model families for inter-frame registration."""

from video_stabilization_tpu_torch.models.motion_models import (  # noqa: F401
    MotionModel,
    fit_affine_masked,
    fit_homography_dlt,
    fit_motion,
)
