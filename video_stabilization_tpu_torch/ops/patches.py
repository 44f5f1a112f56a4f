"""Batched patch extraction by direct indexing.

Port of ``video_stabilization_tpu/ops/patches.py``.  The JAX package builds
all patches with two one-hot selection matmuls because per-keypoint gathers
are slow on a TPU; each contraction copies one bf16 image entry, so its
result is the bf16-rounded image sampled at the patch pixels.  Here that is
one advanced-indexing gather of the bf16-rounded planes.
"""

from __future__ import annotations

import torch


def extract_patches(planes: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                    size: int) -> torch.Tensor:
    """(N, C, size, size) float32 patches of the (C, H, W) ``planes`` with
    top-left corners (``iy``, ``ix``), each (N,) and already clipped to
    [0, H − size] / [0, W − size]; values are rounded to bf16 as the JAX
    package's matmul extraction rounds them."""
    planes16 = planes.to(torch.bfloat16).float()
    span = torch.arange(size, device=planes.device)
    rows = iy.long()[:, None] + span                    # (N, P)
    cols = ix.long()[:, None] + span                    # (N, P)
    out = planes16[:, rows[:, :, None], cols[:, None, :]]   # (C, N, P, P)
    return out.permute(1, 0, 2, 3).contiguous()
