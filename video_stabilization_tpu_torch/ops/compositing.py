"""Warp mask and feathered trail compositing (the reference's dormant path).

Port of ``video_stabilization_tpu/ops/compositing.py``: the reference's
unused "trail" renderer, a corner-polygon warp mask (createWarpedMask,
src/stabilizer.cpp:1011-1040), a Gaussian-feathered alpha compositor over
a fading background (copyFeathered, :1051-1155) and the translation-shift
helper t = (I − s·R)·c (computeTranslationShift, :1042-1049).  Plain tensor
ops on the frame's device: the shear warp (``ops/warp.py``), half-plane
tests and repeated 5-tap blurs.
"""

from __future__ import annotations

import torch

from video_stabilization_tpu_torch.motion.similarity import transform_points
from video_stabilization_tpu_torch.ops.pyramid import sep_filter5
from video_stabilization_tpu_torch.ops.warp import pixel_grid, warp_affine_shear


def compute_translation_shift(scale: torch.Tensor, theta: torch.Tensor,
                              center: torch.Tensor) -> torch.Tensor:
    """t_shift = (I − s·R(θ)) · c."""
    c, s = torch.cos(theta), torch.sin(theta)
    sr = scale * torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return (torch.eye(2, dtype=sr.dtype, device=sr.device) - sr) @ center


def warped_mask(h: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(height, width) bool: where the warped source lands in the
    destination, as four half-plane tests against the warped corner polygon
    (the reference rasterizes it with fillConvexPoly)."""
    # (0, 0), (w-1, 0), (w-1, h-1), (0, h-1), made on the device
    i = torch.arange(4, device=h.device)
    corners = torch.stack([((i + 1) // 2 % 2) * (width - 1), (i // 2) * (height - 1)],
                          -1).float()
    warped = transform_points(h.float(), corners)                  # (4, 2)
    ys, xs = pixel_grid(height, width, h.device)
    inside = torch.ones((height, width), dtype=torch.bool, device=h.device)
    for i in range(4):
        a = warped[i]
        b = warped[(i + 1) % 4]
        # positive side of each (counter-clockwise in y-down coords) edge
        cross = (b[0] - a[0]) * (ys - a[1]) - (b[1] - a[1]) * (xs - a[0])
        inside = inside & (cross >= 0.0)
    return inside


def _big_blur(img: torch.Tensor, passes: int = 12) -> torch.Tensor:
    """The reference's kernel-101 Gaussian feather, approximated by repeated
    5-tap blurs (the variances add)."""
    for _ in range(passes):
        img = sep_filter5(img)
    return img


def copy_feathered(frame: torch.Tensor, background: torch.Tensor, h: torch.Tensor,
                   fade: float = 0.99, feather_passes: int = 12) -> torch.Tensor:
    """Warp ``frame`` ((H, W) or (H, W, C)) by ``h`` and alpha-blend it over
    ``background`` faded by ``fade``: the alpha is the warp mask blurred into
    a feather and cut by the hard mask, so edges fade inward.  Returns the
    new composite (the caller carries it from frame to frame)."""
    frame = frame.float()
    background = background.float()
    warped = warp_affine_shear(frame, h, border_value=0.0)
    mask = warped_mask(h, frame.shape[0], frame.shape[1]).float()
    alpha = _big_blur(mask, feather_passes).clamp(0.0, 1.0) * mask
    if frame.dim() == 3:
        alpha = alpha[..., None]
    return alpha * warped + (1.0 - alpha) * (background * fade)
