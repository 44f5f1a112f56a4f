"""Homography parameterization: decompose / compose / 2x2 QR.

Port of ``video_stabilization_tpu/motion/homography.py``.  A homography is
factored about a rotation centre c as

    H = [[A, t+], [vᵀ, 1]],   A = s·R(θ)·K + t+·vᵀ,   K = [[k1, δ], [0, 1/k1]]

with the translation re-centred, t = t+ − (I − sR)c.  Every function takes
arbitrary leading batch dimensions and returns a ``valid`` mask instead of
raising on degenerate input.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

_EPS = 1e-9


@dataclass(frozen=True)
class HomographyParams:
    """Decomposition parameters; all fields share leading batch dims."""

    scale: torch.Tensor   # (...,)
    theta: torch.Tensor   # (...,) radians
    k: torch.Tensor       # (...,) anisotropy k1 (k2 = 1/k1)
    delta: torch.Tensor   # (...,) shear
    t: torch.Tensor       # (..., 2) translation about the centre
    v: torch.Tensor       # (..., 2) projective row

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "HomographyParams":
        ones = torch.ones(batch_shape, dtype=dtype, device=device)
        zeros = torch.zeros(batch_shape, dtype=dtype, device=device)
        z2 = torch.zeros(tuple(batch_shape) + (2,), dtype=dtype, device=device)
        return HomographyParams(ones, zeros, ones, zeros, z2, z2)


def identity_homography(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Batched 3x3 identity matrices."""
    eye = torch.eye(3, dtype=dtype, device=device)
    return eye.expand(tuple(batch_shape) + (3, 3))


def _mat2(a11, a12, a21, a22) -> torch.Tensor:
    return torch.stack([torch.stack([a11, a12], -1), torch.stack([a21, a22], -1)], -2)


def qr_2x2(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form Gram-Schmidt QR of batched 2x2 matrices -> (q, r, valid);
    q = r = I where ``a`` is numerically singular."""
    a11, a12 = a[..., 0, 0], a[..., 0, 1]
    a21, a22 = a[..., 1, 0], a[..., 1, 1]

    norm1 = torch.sqrt(a11 * a11 + a21 * a21)
    det = a11 * a22 - a12 * a21
    valid = (norm1 > _EPS) & (det.abs() > _EPS)

    one = torch.ones_like(norm1)
    zero = torch.zeros_like(norm1)
    safe_norm1 = torch.where(valid, norm1, one)
    q11 = torch.where(valid, a11 / safe_norm1, one)
    q21 = torch.where(valid, a21 / safe_norm1, zero)

    r12 = q11 * a12 + q21 * a22
    u2x = a12 - r12 * q11
    u2y = a22 - r12 * q21
    norm2 = torch.sqrt(u2x * u2x + u2y * u2y)
    valid = valid & (norm2 > _EPS)
    safe_norm2 = torch.where(valid, norm2, one)
    q12 = torch.where(valid, u2x / safe_norm2, zero)
    q22 = torch.where(valid, u2y / safe_norm2, one)

    r11 = torch.where(valid, norm1, one)
    r22 = torch.where(valid, norm2, one)
    r12 = torch.where(valid, r12, zero)
    return _mat2(q11, q12, q21, q22), _mat2(r11, r12, zero, r22), valid


def _mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) @ (..., 2) as explicit products (f32, no reduced precision)."""
    return torch.stack([m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1],
                        m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]], -1)


def decompose_homography(h: torch.Tensor, rot_center: torch.Tensor
                         ) -> Tuple[HomographyParams, torch.Tensor]:
    """Decompose (..., 3, 3) homographies about ``rot_center`` ((2,) or
    (..., 2)) -> (params, valid); identity parameters where invalid."""
    dtype = h.dtype
    batch = h.shape[:-2]
    rot_center = torch.as_tensor(rot_center, dtype=dtype, device=h.device).expand(batch + (2,))

    h33 = h[..., 2, 2]
    valid = h33.abs() > _EPS
    hn = h / torch.where(valid, h33, torch.ones_like(h33))[..., None, None]

    t_plus = hn[..., 0:2, 2]
    v = hn[..., 2, 0:2]
    a = hn[..., 0:2, 0:2]
    srk = a - t_plus[..., :, None] * v[..., None, :]

    det = srk[..., 0, 0] * srk[..., 1, 1] - srk[..., 0, 1] * srk[..., 1, 0]
    valid = valid & (det > _EPS)
    s = torch.sqrt(torch.where(valid, det, torch.ones_like(det)))

    rk = srk / s[..., None, None]
    q, r, qr_valid = qr_2x2(rk)
    valid = valid & qr_valid

    theta = torch.atan2(q[..., 1, 0], q[..., 0, 0])
    sr = s[..., None, None] * q
    i_minus_sr = torch.eye(2, dtype=dtype, device=h.device) - sr
    t = t_plus - _mat_vec(i_minus_sr, rot_center)

    ident = HomographyParams.identity(batch, dtype, h.device)
    vm = valid

    def pick(x, ident_x):
        m = vm.reshape(vm.shape + (1,) * (x.dim() - vm.dim()))
        return torch.where(m, x, ident_x)

    params = HomographyParams(
        scale=pick(s, ident.scale),
        theta=pick(theta, ident.theta),
        k=pick(r[..., 0, 0], ident.k),
        delta=pick(r[..., 0, 1], ident.delta),
        t=pick(t, ident.t),
        v=pick(v, ident.v),
    )
    return params, valid


def compose_homography(params: HomographyParams, rot_center: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`decompose_homography` (h33 = 1)."""
    s, theta, k1, delta, t, v = (params.scale, params.theta, params.k,
                                 params.delta, params.t, params.v)
    dtype = s.dtype
    batch = s.shape
    rot_center = torch.as_tensor(rot_center, dtype=dtype, device=s.device).expand(batch + (2,))

    c, sn = torch.cos(theta), torch.sin(theta)
    zeros = torch.zeros_like(k1)
    rot = _mat2(c, -sn, sn, c)
    kmat = _mat2(k1, delta, zeros, 1.0 / k1)
    sr = s[..., None, None] * rot
    srk = torch.matmul(sr, kmat)

    i_minus_sr = torch.eye(2, dtype=dtype, device=s.device) - sr
    t_shifted = t + _mat_vec(i_minus_sr, rot_center)
    a = srk + t_shifted[..., :, None] * v[..., None, :]

    top = torch.cat([a, t_shifted[..., :, None]], -1)
    bottom = torch.cat([v[..., None, :], torch.ones(batch + (1, 1), dtype=dtype,
                                                    device=s.device)], -1)
    return torch.cat([top, bottom], -2)


def remove_isotropic_scale(h: torch.Tensor, rot_center: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Force s = 1 about ``rot_center`` (similarity -> rigid); identity where
    the decomposition is invalid.  Returns ``(h_rigid, valid)``."""
    params, valid = decompose_homography(h, rot_center)
    params = replace(params, scale=torch.ones_like(params.scale))
    h_rigid = compose_homography(params, rot_center)
    eye = identity_homography(h.shape[:-2], h.dtype, h.device)
    return torch.where(valid[..., None, None], h_rigid, eye), valid
