"""Image and vision ops; ``affine_warp`` and ``fast`` hold the CUDA kernels."""

from video_stabilization_tpu_torch.ops.affine_warp import (  # noqa: F401
    affine_envelope_ok,
    warp_affine,
)
from video_stabilization_tpu_torch.ops.fast import fast_score  # noqa: F401
from video_stabilization_tpu_torch.ops.filters import preprocess_for_registration  # noqa: F401
from video_stabilization_tpu_torch.ops.gftt import (  # noqa: F401
    Corners,
    good_features_to_track,
    min_eig_response,
)
from video_stabilization_tpu_torch.ops.gradients import box_sum, scharr_xy, sobel_xy  # noqa: F401
from video_stabilization_tpu_torch.ops.image import (  # noqa: F401
    bgr_to_gray,
    resize_bilinear,
    resize_nearest,
)
from video_stabilization_tpu_torch.ops.lk import LKResult, lk_track  # noqa: F401
from video_stabilization_tpu_torch.ops.lk_dense import lk_track_dense  # noqa: F401
from video_stabilization_tpu_torch.ops.match import (  # noqa: F401
    Matches,
    match_hamming_knn,
    match_l2,
)
from video_stabilization_tpu_torch.ops.orb import ORBFeatures, orb_detect_and_compute  # noqa: F401
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid, pyr_down  # noqa: F401
from video_stabilization_tpu_torch.ops.warp import warp_perspective  # noqa: F401
