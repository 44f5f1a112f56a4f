"""Descriptor matching of the ORB and SIFT locks.

Port of ``video_stabilization_tpu/ops/match.py``:

- ``match_hamming_knn`` (ORB): brute-force Hamming kNN (k = 2) and Lowe's
  ratio test (reference: BFMatcher(NORM_HAMMING).knnMatch,
  src/stabilizer.cpp:647-673).  With descriptors as ±1 int8 vectors,
  Hamming(a, b) = (nbits − a·b) / 2, so the distance matrix is one f32
  matrix product, exact for ±1 entries.
- ``match_l2`` (SIFT): nearest-neighbour L2 matching and the reference's
  mean-distance filter (distance <= max(0.5·mean, 0.02),
  src/stabilizer.cpp:675-707), with ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b as one f32
  matrix product (TF32 must be off, as ``Stabilizer`` sets it).

Both return fixed-shape matches with validity masks; ``argmin`` takes the
first index on ties, as in the JAX package.
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


def match_l2(desc1: torch.Tensor, mask1: torch.Tensor,
             desc2: torch.Tensor, mask2: torch.Tensor,
             avg_ratio: float = 0.5, min_distance: float = 0.02) -> Matches:
    """Nearest-neighbour L2 matching + the reference's SIFT distance filter:
    keep matches with distance <= max(avg_ratio · mean, min_distance), the
    mean over the valid best matches."""
    a = desc1.float()
    b = desc2.float()
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    d2 = (a2 + b2.T - 2.0 * (a @ b.T)).clamp_min(0.0)
    d2 = torch.where(mask2[None, :], d2, _BIG)
    best = torch.argmin(d2, 1)                                  # first minimum
    dist = torch.sqrt(torch.gather(d2, 1, best[:, None])[:, 0])
    base_valid = mask1 & (dist < _BIG / 2)
    n_valid = base_valid.to(torch.int32).sum().clamp_min(1)
    avg = torch.where(base_valid, dist, 0.0).sum() / n_valid
    thresh = torch.clamp_min(avg_ratio * avg, min_distance)
    valid = base_valid & (dist <= thresh)
    return Matches(idx=best, distance=dist, valid=valid)
