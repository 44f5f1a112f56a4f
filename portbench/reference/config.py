"""The reference's configuration: a frozen copy of the program's
``config.py`` with the fields the reference reads (the same names and
defaults), so one configuration file builds both.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class StabilizationMode(enum.IntEnum):
    """Stabilization modes (reference: include/stabilizer.hpp:31-38).  The
    values are the JAX package's: the carry holds the mode as an int32."""

    GLOBAL_SMOOTHING = 0
    ACCUMULATED_FULL_LOCK = 1
    ORB_FULL_LOCK = 2
    SIFT_FULL_LOCK = 3
    TRANSLATION_LOCK = 4
    ROTATION_LOCK = 5


@dataclasses.dataclass(frozen=True)
class GFTTConfig:
    """Shi-Tomasi good-features-to-track (reference: src/stabilizer.cpp:933-945)."""

    max_features: int = 1280
    quality_level: float = 0.01
    min_distance_at_720: float = 10.0   # scaled by working_height / 720
    block_size: int = 3
    gradient_size: int = 3
    selection: str = "cell"             # "cell" | "cv2exact" | "host"
    max_candidates: int = 6144


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas-Kanade (reference: src/stabilizer.cpp:185-190)."""

    window_size: int = 21
    pyramid_levels: int = 3             # maxLevel=3 => 4 levels total (0..3)
    max_iters: int = 50
    epsilon: float = 0.01
    min_eig_threshold: float = 1e-4
    method: str = "dense"               # "dense" | "sweep" | "cv2exact"
    corner_polish_iters: int = 0        # per-point polish after dense LK
    warp_fallback: bool = True


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Robust similarity fit (reference: src/stabilizer.cpp:224-225, 510-511)."""

    num_hypotheses: int = 256
    inlier_threshold: float = 3.0       # px
    lock_inlier_threshold: float = 5.0  # ORB/SIFT lock path (:510-511)
    refine_iters: int = 2
    min_points: int = 10                # MIN_POINTS_FOR_MOTION_ESTIMATION (:20)
    motion_model: str = "rigid"         # rigid | similarity | affine | homography
    method: str = "vmapped"             # "vmapped" | "cv2exact" (host estimator)


@dataclasses.dataclass(frozen=True)
class StabilizerConfig:
    """Top-level engine configuration; ``past_frames`` / ``future_frames``
    are the temporal window sides in frames."""

    past_frames: int = 60
    future_frames: int = 45
    working_height: int = 360
    frame_height: int = 720
    frame_width: int = 1280
    channels: int = 3

    gftt: GFTTConfig = GFTTConfig()
    lk: LKConfig = LKConfig()
    ransac: RansacConfig = RansacConfig()

    reference_compat: bool = False
    # False always takes the 2-pass resample in affine_warp.py
    warp_projective_fallback: bool = True

    def __post_init__(self) -> None:
        if self.past_frames < 0 or self.future_frames < 0:
            raise ValueError("window sides must be non-negative")
        if self.past_frames == 0 and self.future_frames == 0:
            raise ValueError("past and future frame windows cannot both be zero")
        if not (90 < self.working_height <= 2160):
            raise ValueError("working_height must be in (90, 2160]")
        if self.frame_height <= 10 or self.frame_width <= 10:
            raise ValueError("frame size must exceed 10x10")

    @property
    def total_window(self) -> int:
        """past + 1 + future (reference: include/stabilizer.hpp:196-198)."""
        return self.past_frames + 1 + self.future_frames

    @property
    def scale_factor(self) -> float:
        """working_height / frame_height (reference: src/stabilizer.cpp:117-119)."""
        return self.working_height / self.frame_height

    @property
    def working_size(self) -> Tuple[int, int]:
        """(height, width) at working resolution, preserving aspect ratio."""
        h = self.working_height
        w = int(round(self.frame_width * self.scale_factor))
        return (h, w)
