"""The ``lk_track`` entry point of the plain reference: a frozen copy of the
program's ``ops/lk.py`` for dense LK, the cells' method."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from portbench.reference.config import LKConfig


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
    from portbench.reference.lk_dense import lk_track_dense

    return lk_track_dense(pyr_prev, pyr_next, points, mask, config)
