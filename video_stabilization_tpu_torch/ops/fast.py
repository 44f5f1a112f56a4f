"""FAST-9/16 corner score maps, alone or fused with ORB's NMS and edge mask.

Port of ``video_stabilization_tpu/ops/fast.py``.  A pixel p is a corner if 9
or more contiguous pixels of the 16-pixel Bresenham circle of radius 3 are
all brighter than p + t or all darker than p − t.  The score (FAST_SCORE) is
the largest threshold at which p stays a corner: the maximum over the 16
contiguous 9-arcs of the arc's weakest margin, for both polarities.

:func:`fast_levels` computes, for every level of an ORB pyramid at once,
what the JAX package's ``orb._detect_level`` computes per level: the score,
the 3x3 non-maximum suppression and the edge-threshold mask.  On a CUDA
tensor it is one launch of the hand-written kernel of ``csrc/fast_score.cu``;
on a CPU tensor its plain version :func:`fast_levels_plain`.
:func:`fast_score` is the score map of one image (the same kernel with a
one-level table, NMS and mask off; :func:`fast_score_plain`, the port of the
JAX package's ``fast_score_xla``, on the CPU).  The only rounding operation
is the margin ``ring − center``; min, max, negation and comparisons are
exact, so the kernel and the plain versions agree bit for bit.
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

ARC_LEN = 9              # contiguous circle pixels that make a corner

# Launches of the CUDA kernel: a plain integer that a caller resets and
# reads around the run it wants to account for.
launches = 0
MAX_LEVELS = 16          # levels one launch takes (csrc/fast_score.cu)

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_kernel("fast_score")
        fn = lib.vstab_fast_levels
        # host arrays of pointers: c_void_p elements, or ctypes cuts them to 32 bits
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
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


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """Keep positive 3x3 local maxima (ties keep all); neighbours off the
    image do not count (``max_pool2d`` pads with −inf, as the JAX package's
    ``reduce_window``)."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= neigh) & (score > 0), score, 0.0)


def fast_levels_plain(imgs, threshold: float, edge: int) -> list:
    """Plain PyTorch version of :func:`fast_levels`: per (h, w) image the
    FAST score, its 3x3 NMS, and zero outside ``[edge, h−edge) x
    [edge, w−edge)``."""
    out = []
    for img in imgs:
        h, w = img.shape
        score, _ = fast_score_plain(img, threshold)
        inside = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        inside[edge:h - edge, edge:w - edge] = True
        out.append(torch.where(inside, _nms3(score), 0.0))
    return out


def _launch(imgs, threshold: float, edge: int, nms: bool) -> list:
    """One launch over every image of ``imgs`` (CUDA, one device); returns
    the (h, w) score maps, views of one allocation."""
    dev = imgs[0].device
    if dev.type != "cuda":
        raise ValueError(f"fast: unsupported device {dev}")
    if not 1 <= len(imgs) <= MAX_LEVELS:
        raise ValueError(f"fast: 1 to {MAX_LEVELS} images per launch, got {len(imgs)}")
    for img in imgs:
        if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
            raise ValueError("fast: each image must be a contiguous 2-d float32 tensor, "
                             f"got {img.dtype} {tuple(img.shape)}")
        if img.device != dev:
            raise ValueError(f"fast: images on {img.device} and {dev}")
        if img.numel() == 0:
            raise ValueError(f"fast: empty image {tuple(img.shape)}")
    sizes = [img.numel() for img in imgs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs = [part.view(img.shape) for part, img in zip(flat.split(sizes), imgs)]
    n = len(imgs)
    # the entry point makes the images' device current for the launch
    err = _kernel_lib().vstab_fast_levels(
        (ctypes.c_void_p * n)(*[img.data_ptr() for img in imgs]),
        (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * n)(*[img.shape[0] for img in imgs]),
        (ctypes.c_int * n)(*[img.shape[1] for img in imgs]),
        n, float(threshold), int(edge), int(nms), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_levels launch failed: CUDA error {err}")
    global launches
    launches += 1
    return outs


def fast_levels(imgs, threshold: float, edge: int) -> list:
    """ORB's per-level detection maps of up to 16 (h, w) float32 images:
    the FAST score, 3x3 NMS, zero within ``edge`` px of the border.

    CPU tensors go to :func:`fast_levels_plain`; CUDA tensors to one launch
    of the kernel, which raises rather than falls back if it cannot run."""
    if imgs[0].device.type == "cpu":
        return fast_levels_plain(imgs, threshold, edge)
    return _launch(imgs, threshold, edge, nms=True)


def fast_score(img: torch.Tensor, threshold: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, score > 0) maps of an (H, W) float32 image.

    A CPU tensor goes to :func:`fast_score_plain`; a CUDA tensor to the
    kernel, which raises rather than falls back if it cannot run."""
    if img.device.type == "cpu":
        score, _ = fast_score_plain(img, threshold)
        return score, score > 0
    if img.dim() == 2 and img.numel() == 0:
        score = torch.empty(img.shape, dtype=torch.float32, device=img.device)
        return score, score > 0
    score = _launch([img], threshold, 0, nms=False)[0]
    return score, score > 0
