"""FAST-9/16 corner score map.

Port of ``video_stabilization_tpu/ops/fast.py``.  A pixel p is a corner if 9
or more contiguous pixels of the 16-pixel Bresenham circle of radius 3 are
all brighter than p + t or all darker than p − t.  The score (FAST_SCORE) is
the largest threshold at which p stays a corner: the maximum over the 16
contiguous 9-arcs of the arc's weakest margin, for both polarities.

:func:`fast_score` runs the hand-written kernel of ``csrc/fast_score.cu`` on
a CUDA tensor and :func:`fast_score_plain` (the port of the JAX package's
``fast_score_xla``) on a CPU tensor.  The only rounding operation is the
margin ``ring − center``; min, max and negation are exact, so the kernel and
the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from video_stabilization_tpu_torch.utils.cuda_build import load_kernel

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

# Launches of the CUDA kernel: a plain integer that a caller resets and
# reads around the run it wants to account for.
launches = 0

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_kernel("fast_score")
        fn = lib.vstab_fast_score
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fast_score_plain(img: torch.Tensor, threshold: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (score, is_corner) maps of an (H, W) image,
    zero within 3 px of the border, edge-padded ring reads."""
    img = img.float()
    h, w = img.shape
    pad = 3
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    ring = torch.stack([x[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
                        for dy, dx in CIRCLE_OFFSETS])                # (16, H, W)
    margin = ring - img[None]

    def roll(a, k):
        return torch.cat([a[k:], a[:k]], 0)

    def arc9(m, op):
        # every contiguous 9-arc by doubling: 2, 4, 8, then the 9th entry
        m2 = op(m, roll(m, 1))
        m4 = op(m2, roll(m2, 2))
        m8 = op(m4, roll(m4, 4))
        return op(m8, roll(m, 8))

    score_bright = arc9(margin, torch.minimum).amax(0)
    score_dark = (-arc9(margin, torch.maximum)).amax(0)
    score = torch.maximum(score_bright, score_dark)
    border = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    border[pad:-pad, pad:-pad] = True
    is_corner = (score > threshold) & border
    return torch.where(is_corner, score, 0.0), is_corner


def _check(img: torch.Tensor) -> None:
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("fast_score: img must be a contiguous 2-d float32 tensor, "
                         f"got {img.dtype} {tuple(img.shape)}")


def fast_score(img: torch.Tensor, threshold: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, score > 0) maps of an (H, W) float32 image.

    A CPU tensor goes to :func:`fast_score_plain`; a CUDA tensor to the
    kernel, which raises rather than falls back if it cannot run."""
    if img.device.type == "cpu":
        score, _ = fast_score_plain(img, threshold)
        return score, score > 0
    if img.device.type != "cuda":
        raise ValueError(f"fast_score: unsupported device {img.device}")
    _check(img)
    h, w = img.shape
    score = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if score.numel() == 0:
        return score, score > 0
    fn = _kernel_lib().vstab_fast_score
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), score.data_ptr(), h, w, float(threshold),
                 torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_score launch failed: CUDA error {err}")
    global launches
    launches += 1
    return score, score > 0
