"""Camera simulator with analytic ground truth."""

from video_stabilization_tpu_torch.sim.camera_engine import (  # noqa: F401
    CameraParams,
    DEFAULT_APP_PARAMS,
    DEFAULT_PARAMS,
    inter_frame_homography,
    move_backward,
    move_down,
    move_forward,
    move_left,
    move_right,
    move_up,
    plane_to_pixel_homography,
    render_frame,
    roll_clockwise,
    roll_counterclockwise,
    rotation_matrix,
)
from video_stabilization_tpu_torch.sim.trajectory import (  # noqa: F401
    make_default_texture,
    shake_trajectory,
    smooth_pan_trajectory,
)
