"""Gaussian image pyramid (cv2.pyrDown) with reflect-101 borders.

Port of ``video_stabilization_tpu/ops/pyramid.py`` (``pyr_down``,
``build_pyramid``, ``sep_filter5``).  Taps are summed in the
same order as the JAX package so the sums associate the same way.
"""

from __future__ import annotations

from typing import Tuple

import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect101_pad(img: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding along ``axis`` (edge pixel not repeated)."""
    n = img.shape[axis]
    left = img.narrow(axis, 1, pad).flip(axis)
    right = img.narrow(axis, n - 1 - pad, pad).flip(axis)
    return torch.cat([left, img, right], dim=axis)


def _taps(x: torch.Tensor, kernel, n: int, axis: int, stride: int = 1) -> torch.Tensor:
    """sum_k kernel[k] · x[k : k + stride·(n−1) + 1 : stride] along ``axis``."""
    axis = axis % x.dim()
    idx = (slice(None),) * axis
    out = 0
    for k, wk in enumerate(kernel):
        sl = x.narrow(axis, k, stride * (n - 1) + 1)[idx + (slice(None, None, stride),)]
        out = out + wk * sl
    return out


def sep_filter5(img: torch.Tensor, kernel=_K5) -> torch.Tensor:
    """Separable 5-tap filter of (..., H, W) with reflect-101 borders."""
    rows = _taps(_reflect101_pad(img, 2, -2), kernel, img.shape[-2], -2)
    return _taps(_reflect101_pad(rows, 2, -1), kernel, img.shape[-1], -1)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur evaluated at even rows/cols only (cv2.pyrDown)."""
    img = img.float()
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    rows = _taps(_reflect101_pad(img, 2, -2), _K5, oh, -2, stride=2)
    return _taps(_reflect101_pad(rows, 2, -1), _K5, ow, -1, stride=2)


def build_pyramid(img: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """Levels 0..levels inclusive, level 0 = the input."""
    pyr = [img.float()]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return tuple(pyr)
