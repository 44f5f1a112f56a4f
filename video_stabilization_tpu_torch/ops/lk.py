"""Pyramidal sparse optical flow: the ``lk_track`` entry point.

Port of the dispatch in ``video_stabilization_tpu/ops/lk.py``.  Only
``method="dense"`` (``ops/lk_dense.py``) is ported; the per-point sweep and
the cv2exact referee wait for ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from video_stabilization_tpu_torch.config import LKConfig


@dataclass
class LKResult:
    points: torch.Tensor   # (..., N, 2) f32 tracked locations
    status: torch.Tensor   # (..., N) bool
    error: torch.Tensor    # (..., N) f32 mean |residual| over the window


def lk_track(pyr_prev: Sequence[torch.Tensor], pyr_next: Sequence[torch.Tensor],
             points: torch.Tensor, mask: torch.Tensor,
             config: LKConfig = LKConfig()) -> LKResult:
    """Track (N, 2) level-0 ``points`` from ``pyr_prev`` to ``pyr_next``, or
    a batch of pairs: levels (B, h, w), points (B, N, 2)."""
    if config.method != "dense":
        raise NotImplementedError(
            f"lk.method={config.method!r} is not ported yet "
            "(ROADMAP Queue 1 item 14); only 'dense' is")
    from video_stabilization_tpu_torch.ops.lk_dense import lk_track_dense

    return lk_track_dense(pyr_prev, pyr_next, points, mask, config)
