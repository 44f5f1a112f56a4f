"""Configuration of the port: the stabilization modes and the frozen configs.

The port's own copy of ``video_stabilization_tpu/config.py``: the same class
names, fields and defaults, so a reader finds each counterpart at once
(``tests/test_torch_config.py`` holds every default equal to the JAX
package's).  Comments on a field say what the port does with it where that
differs from the JAX package.

:func:`config_from_fields` rebuilds a :class:`StabilizerConfig` from any
object with the same fields, read attribute by attribute: that is how one
configuration drives both packages.
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
    selection: str = "cell"             # the port runs "cell" only
    max_candidates: int = 6144


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas-Kanade (reference: src/stabilizer.cpp:185-190)."""

    window_size: int = 21
    pyramid_levels: int = 3             # maxLevel=3 => 4 levels total (0..3)
    max_iters: int = 50
    epsilon: float = 0.01
    min_eig_threshold: float = 1e-4
    method: str = "dense"               # the port runs "dense" only
    corner_polish_iters: int = 0        # the port runs 0 only
    warp_fallback: bool = True


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Robust similarity fit (reference: src/stabilizer.cpp:224-225, 510-511)."""

    num_hypotheses: int = 256
    inlier_threshold: float = 3.0       # px
    lock_inlier_threshold: float = 5.0  # ORB/SIFT lock path (:510-511)
    refine_iters: int = 2
    min_points: int = 10                # MIN_POINTS_FOR_MOTION_ESTIMATION (:20)
    motion_model: str = "rigid"         # the port runs "rigid" only
    method: str = "vmapped"             # the port runs "vmapped" only


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB detect/describe (reference: src/stabilizer.cpp:483-493)."""

    max_features: int = 2560
    scale_factor: float = 1.2
    n_levels: int = 12
    edge_threshold: int = 31
    patch_size: int = 31
    fast_threshold: int = 20
    lowe_ratio: float = 0.6
    max_keypoint_size_ratio: float = 0.10
    pattern: str = "cv2"                # "cv2" learned pairs or "brief"


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    """SIFT detect/describe (reference: src/stabilizer.cpp:496-507); the
    port sizes the SIFT reference of the carry from it."""

    max_features: int = 2560
    n_octave_layers: int = 3
    contrast_threshold: float = 0.04
    edge_threshold: float = 5.0
    sigma: float = 1.2
    max_keypoint_size_ratio: float = 0.05
    match_avg_ratio: float = 0.5
    match_min_distance: float = 0.02
    upsample_2x: bool = False
    multi_orientation: bool = False
    ori_peak_ratio: float = 0.8


@dataclasses.dataclass(frozen=True)
class ECCConfig:
    """ECC Euclidean refinement (reference: src/stabilizer.cpp:760-782)."""

    enabled: bool = False
    max_iters: int = 100
    epsilon: float = 0.001


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """ORB/SIFT preprocessing chain (reference: src/stabilizer.cpp:464-477):
    median5 -> sharpen3x3 -> CLAHE -> median5."""

    median_ksize: int = 5
    clahe_clip_limit: float = 2.0
    clahe_tiles: Tuple[int, int] = (8, 8)


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
    orb: ORBConfig = ORBConfig()
    sift: SIFTConfig = SIFTConfig()
    ecc: ECCConfig = ECCConfig()
    preprocess: PreprocessConfig = PreprocessConfig()

    reference_compat: bool = False      # the port refuses True
    # False always takes the 2-pass resample in ops/affine_warp.py
    warp_projective_fallback: bool = True
    # pins the mode: ``Stabilizer`` then ignores its own
    static_mode: int | None = None
    image_dtype: str = "float32"

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


def _rebuild(cls, obj):
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
        if dataclasses.is_dataclass(f.default):
            val = _rebuild(type(f.default), val)
        elif isinstance(val, enum.Enum):
            val = val.value
        kw[f.name] = val
    return cls(**kw)


def config_from_fields(obj) -> StabilizerConfig:
    """The port's :class:`StabilizerConfig` with every field read from
    ``obj``, an object with the same fields (nested configs included), such
    as the JAX package's config."""
    return _rebuild(StabilizerConfig, obj)
