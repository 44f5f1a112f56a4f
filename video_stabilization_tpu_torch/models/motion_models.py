"""Motion-model family: rigid / similarity / affine / homography fits.

Port of ``video_stabilization_tpu/models/motion_models.py``.  Every fit is a
weighted least-squares fit of masked (..., N, 2) correspondences over any
leading dimensions, so each can serve as RANSAC's refit
(``motion/ransac.py``'s ``refit_fn``):

- RIGID:      similarity fit + isotropic-scale removal (the reference's)
- SIMILARITY: closed-form weighted LS (4 DoF)
- AFFINE:     6-DoF weighted normal equations
- HOMOGRAPHY: 8-DoF Hartley-normalized DLT

None reads anything back to the host: ``torch.linalg``'s ``det``,
``solve`` and ``eigh`` check their results on the host on a CUDA card, so
the 3x3 systems are solved in closed form (adjugate over determinant) and
the DLT's smallest eigenvector comes from repeated squaring (see
:func:`_smallest_eigvec`).  Both normal matrices are formed and solved in
float64, so a fit does not depend on the order a batch sums in.
"""

from __future__ import annotations

import enum
import math
from typing import Tuple

import torch

from video_stabilization_tpu_torch.motion.homography import remove_isotropic_scale
from video_stabilization_tpu_torch.motion.similarity import fit_similarity_masked
from video_stabilization_tpu_torch.ops.warp import _inv3x3

_EPS = 1e-8
# squarings of (I - A/tr A): the eigenvector converges as (1 - λ₂/tr A)^(2^k),
# so 2^40 ≈ 1e12 separates gaps down to ~3e-11 of the trace in float64
_SQUARINGS = 40


class MotionModel(enum.Enum):
    RIGID = "rigid"
    SIMILARITY = "similarity"
    AFFINE = "affine"
    HOMOGRAPHY = "homography"


def _det3x3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors of the first row."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _identity_like(h: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=h.dtype, device=h.device).expand(h.shape)


def fit_affine_masked(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted LS affine fit (6 DoF) of (..., N, 2) correspondences: the
    3x3 normal equations per output coordinate, in float64.  In pixel
    coordinates their sums reach N·W² and their condition number ~1e5, so
    in float32 a change in summation order (a batch of fits on the card
    sums in another order than one fit) moves the solution by tenths of a
    pixel.  Returns (h (..., 3, 3) f32, valid (...)); identity where
    invalid."""
    w = weights.double()
    src64 = src.double()
    a = torch.cat([src64, torch.ones_like(src64[..., :1])], -1)      # (..., N, 3)
    aw = a * w[..., None]
    ata = a.mT @ aw                                                   # (..., 3, 3)
    det_ok = _det3x3(ata).abs() > _EPS
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device)
    ata_safe = torch.where(det_ok[..., None, None], ata, eye)
    sol = (_inv3x3(ata_safe) @ (aw.mT @ dst.double())).float()        # (..., 3, 2)
    last = torch.zeros(sol.shape[:-2] + (1, 3), dtype=sol.dtype, device=sol.device)
    last[..., 2] = 1.0
    h = torch.cat([sol.mT, last], -2)
    valid = (det_ok & torch.isfinite(h).flatten(-2).all(-1)
             & ((w > 0).sum(-1) >= 3))
    return torch.where(valid[..., None, None], h, _identity_like(h)), valid


def _smallest_eigvec(ata: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of the symmetric PSD
    (..., n, n) ``ata``, in float64, with tensor ops only: M = I − A/tr A
    has the eigenvalues 1 − λ/tr A in [0, 1], so M^(2^k) (each square
    rescaled by its trace) tends to v·vᵀ, and its column of the largest
    diagonal entry is v up to sign."""
    a = ata.double()
    n = a.shape[-1]
    tr = a.diagonal(dim1=-2, dim2=-1).sum(-1).clamp(min=1e-300)
    m = torch.eye(n, dtype=a.dtype, device=a.device) - a / tr[..., None, None]
    for _ in range(_SQUARINGS):
        m = m @ m
        m = m / m.diagonal(dim1=-2, dim2=-1).sum(-1).clamp(min=1e-300)[..., None, None]
    j = m.diagonal(dim1=-2, dim2=-1).argmax(-1)
    v = torch.take_along_dim(m, j[..., None, None], dim=-1)[..., 0]
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-300)


def fit_homography_dlt(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Hartley-normalized DLT homography fit (8 DoF) of (..., N, 2)
    correspondences: 2N x 9 design matrix, the smallest eigenvector of its
    9x9 normal matrix, denormalized and divided by h33 (which removes the
    eigenvector's free sign).  Returns (h (..., 3, 3), valid (...))."""
    w = weights.float()
    wsum = w.sum(-1).clamp(min=_EPS)

    def normalize(pts):
        mu = (w[..., None] * pts).sum(-2) / wsum[..., None]               # (..., 2)
        d = torch.sqrt(((pts - mu[..., None, :]) ** 2).sum(-1))
        mean_d = ((w * d).sum(-1) / wsum).clamp(min=_EPS)
        s = math.sqrt(2.0) / mean_d
        return (pts - mu[..., None, :]) * s[..., None, None], mu, s

    sn, mu_s, s_s = normalize(src)
    dn, mu_d, s_d = normalize(dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)         # (..., 2N, 9)
    a = a.double()
    hn = _smallest_eigvec(a.mT @ a).float().unflatten(-1, (3, 3))

    # H = T_dst⁻¹ · Hn · T_src, T = [[s, 0, -s·μx], [0, s, -s·μy], [0, 0, 1]]
    zs = torch.zeros_like(s_s)
    os_ = torch.ones_like(s_s)
    t_src = torch.stack([torch.stack([s_s, zs, -s_s * mu_s[..., 0]], -1),
                         torch.stack([zs, s_s, -s_s * mu_s[..., 1]], -1),
                         torch.stack([zs, zs, os_], -1)], -2)
    t_dst_inv = torch.stack([torch.stack([1.0 / s_d, zs, mu_d[..., 0]], -1),
                             torch.stack([zs, 1.0 / s_d, mu_d[..., 1]], -1),
                             torch.stack([zs, zs, os_], -1)], -2)
    h = t_dst_inv @ (hn @ t_src)
    h33 = h[..., 2, 2]
    valid = (h33.abs() > _EPS) & ((w > 0).sum(-1) >= 4)
    h = h / torch.where(valid, h33, torch.ones_like(h33))[..., None, None]
    valid = valid & torch.isfinite(h).flatten(-2).all(-1)
    return torch.where(valid[..., None, None], h, _identity_like(h)), valid


def fit_motion(model: MotionModel, src: torch.Tensor, dst: torch.Tensor,
               weights: torch.Tensor, rot_center: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the chosen motion family to masked correspondences."""
    if model is MotionModel.SIMILARITY:
        return fit_similarity_masked(src, dst, weights)
    if model is MotionModel.RIGID:
        h, ok = fit_similarity_masked(src, dst, weights)
        h2, ok2 = remove_isotropic_scale(h, rot_center)
        return h2, ok & ok2
    if model is MotionModel.AFFINE:
        return fit_affine_masked(src, dst, weights)
    if model is MotionModel.HOMOGRAPHY:
        return fit_homography_dlt(src, dst, weights)
    raise ValueError(model)
