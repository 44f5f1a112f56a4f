"""Sobel / Scharr gradients and box sums with reflect-101 borders.

Port of ``video_stabilization_tpu/ops/gradients.py``; same tap order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.pyramid import _reflect101_pad, _taps


def _sep3(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """3-tap separable filter: kv along rows (y), kh along cols (x)."""
    rows = _taps(_reflect101_pad(img, 1, -2), kv, img.shape[-2], -2)
    return _taps(_reflect101_pad(rows, 1, -1), kh, img.shape[-1], -1)


def sobel_xy(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel dx, dy with a 3x3 aperture."""
    img = img.float()
    return (_sep3(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)),
            _sep3(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)))


def scharr_xy(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr dx, dy scaled by 1/32 (OpenCV LK derivative convention)."""
    img = img.float()
    k = (3 / 32, 10 / 32, 3 / 32)
    return _sep3(img, k, (-1.0, 0.0, 1.0)), _sep3(img, (-1.0, 0.0, 1.0), k)


def box_sum(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize box sum with reflect-101 borders."""
    pad = ksize // 2
    ones = (1.0,) * ksize
    rows = _taps(_reflect101_pad(img, pad, -2), ones, img.shape[-2], -2)
    return _taps(_reflect101_pad(rows, pad, -1), ones, img.shape[-1], -1)
