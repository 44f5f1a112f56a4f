"""Descriptor matching of the ORB lock.

Port of ``video_stabilization_tpu/ops/match.py`` (``match_hamming_knn``):
brute-force Hamming kNN (k = 2) and Lowe's ratio test (reference:
BFMatcher(NORM_HAMMING).knnMatch, src/stabilizer.cpp:647-673).  With
descriptors as ±1 int8 vectors, Hamming(a, b) = (nbits − a·b) / 2, so the
distance matrix is one f32 matrix product, exact for ±1 entries.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_BIG = 1e9


@dataclass
class Matches:
    idx: torch.Tensor       # (N,) int64, best match in the second set
    distance: torch.Tensor  # (N,) f32
    valid: torch.Tensor     # (N,) bool, passed the masks and the ratio test


def match_hamming_knn(desc1: torch.Tensor, mask1: torch.Tensor,
                      desc2: torch.Tensor, mask2: torch.Tensor,
                      lowe_ratio: float = 0.6) -> Matches:
    """kNN (k = 2) Hamming matching of ±1 int8 descriptor sets + ratio test."""
    nbits = desc1.shape[1]
    dots = desc1.float() @ desc2.float().T                      # (N, M)
    dist = 0.5 * (nbits - dots)
    dist = torch.where(mask2[None, :], dist, _BIG)
    best = torch.argmin(dist, 1)                                # first minimum
    d1 = torch.gather(dist, 1, best[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)[None, :]
    d2 = torch.where(cols == best[:, None], _BIG, dist).amin(1)
    valid = mask1 & (d1 < _BIG / 2) & (d2 < _BIG / 2) & (d1 < lowe_ratio * d2)
    return Matches(idx=best, distance=d1, valid=valid)
