"""Masked least-squares similarity fitting (closed form, batched).

Port of ``video_stabilization_tpu/motion/similarity.py``: the weighted LS
fit of p' = s·R(θ)·p + t via weighted centroids, vectorized over any leading
batch dimensions (RANSAC hypotheses).
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8


def fit_similarity_masked(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted LS similarity mapping (..., N, 2) ``src`` -> ``dst`` with
    (..., N) weights.  Returns (h (..., 3, 3), valid (...,)); identity where
    the weights or the geometry are degenerate."""
    w = weights.to(src.dtype)
    wsum = w.sum(-1)
    valid = wsum > _EPS
    one = torch.ones_like(wsum)
    zero = torch.zeros_like(wsum)
    wsafe = torch.where(valid, wsum, one)

    mu_src = (w[..., None] * src).sum(-2) / wsafe[..., None]
    mu_dst = (w[..., None] * dst).sum(-2) / wsafe[..., None]
    ps = src - mu_src[..., None, :]
    pd = dst - mu_dst[..., None, :]

    denom = (w * (ps * ps).sum(-1)).sum(-1)
    num_a = (w * (ps * pd).sum(-1)).sum(-1)
    num_b = (w * (ps[..., 0] * pd[..., 1] - ps[..., 1] * pd[..., 0])).sum(-1)
    valid = valid & (denom > _EPS)
    dsafe = torch.where(valid, denom, one)
    a = torch.where(valid, num_a / dsafe, one)
    b = torch.where(valid, num_b / dsafe, zero)

    tx = mu_dst[..., 0] - (a * mu_src[..., 0] - b * mu_src[..., 1])
    ty = mu_dst[..., 1] - (b * mu_src[..., 0] + a * mu_src[..., 1])
    tx = torch.where(valid, tx, zero)
    ty = torch.where(valid, ty, zero)
    h = torch.stack([
        torch.stack([a, -b, tx], -1),
        torch.stack([b, a, ty], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return h, valid


def similarity_from_2pt(src: torch.Tensor, dst: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact similarity from (..., 2, 2) point pairs (the RANSAC minimal
    solver); identity and invalid where the two source points coincide."""
    return fit_similarity_masked(src, dst, torch.ones(src.shape[:-1], dtype=src.dtype,
                                                      device=src.device))


def transform_points(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) homographies to (..., N, 2) points (projective)."""
    x, y = pts[..., 0], pts[..., 1]
    hx = h[..., 0, 0, None] * x + h[..., 0, 1, None] * y + h[..., 0, 2, None]
    hy = h[..., 1, 0, None] * x + h[..., 1, 1, None] * y + h[..., 1, 2, None]
    hw = h[..., 2, 0, None] * x + h[..., 2, 1, None] * y + h[..., 2, 2, None]
    hw = torch.where(hw.abs() > _EPS, hw, torch.ones_like(hw))
    return torch.stack([hx / hw, hy / hw], -1)
