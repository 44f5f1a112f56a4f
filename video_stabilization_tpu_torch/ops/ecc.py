"""ECC image alignment (Evangelidis-Psarakis), Euclidean motion model.

Port of ``video_stabilization_tpu/ops/ecc.py``: the equivalent of
``cv::findTransformECC(ref, cur, warp, MOTION_EUCLIDEAN)``, which the
reference implements for the ORB/SIFT lock but ships disabled
(src/stabilizer.cpp:34, :760-782).  Forward-additive ECC over
p = (theta, tx, ty)::

    W(x; p) = R(theta) x + t
    rho(p)  = <zm_t, zm_iw> / (||zm_t|| ||zm_iw||)

with the standard ECC update (lambda-scaled residual projected through the
Jacobian-weighted gradient Gram matrix).  Every warp is
:func:`~video_stabilization_tpu_torch.ops.affine_warp.warp_affine`, the
hand-written kernel on a CUDA tensor: ``max_iters`` warps in the loop, then
the final and the initial transform's.

The JAX package's ``lax.scan`` is a Python loop over all ``max_iters``
iterations; the convergence freeze (``done``) is a tensor, never read on the
host, so an iteration costs no sync.  The 3x3 Gram matrix is inverted in
closed form (adjugate over determinant, :func:`_inv3x3_f64`), in float64:
on a 360x640 frame its entries span five orders of magnitude (up to ~5e12)
and its determinant is ~1e27.  ``torch.linalg.inv`` is not used because it
checks its result on the host, which would sync every iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from video_stabilization_tpu_torch.ops.affine_warp import warp_affine
from video_stabilization_tpu_torch.ops.warp import _inv3x3


@dataclass
class ECCResult:
    h: torch.Tensor      # (3, 3) refined transform (ref coords -> cur coords)
    rho: torch.Tensor    # () final correlation coefficient
    valid: torch.Tensor  # () bool: improved and finite
    # () correlation at h_init; not in the JAX package's result: rho >
    # rho_init tells a refinement from a no-op, which is also valid
    rho_init: torch.Tensor


def _euclidean_h(theta: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, tx]), torch.stack([s, c, ty]),
                        torch.stack([zero, zero, one])])


def _params_from_h(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return torch.atan2(h[1, 0], h[0, 0]), h[0, 2], h[1, 2]


def _inv3x3_f64(m: torch.Tensor) -> torch.Tensor:
    """Inverse of the (3, 3) f32 matrix ``m``, computed in float64 as the
    adjugate (cross products of its rows) over the determinant; f32 out.  A
    singular matrix gives non-finite entries, as ``jnp.linalg.inv`` does."""
    m = m.double()
    # rows r1 x r2, r2 x r0, r0 x r1 (rolls: no index upload)
    cof = torch.linalg.cross(m.roll(-1, 0), m.roll(-2, 0))
    det = (m[0] * cof[0]).sum()
    return (cof.T / det).float()


def ecc_refine_euclidean(
    ref: torch.Tensor,
    cur: torch.Tensor,
    h_init: torch.Tensor,
    max_iters: int = 50,
    eps: float = 1e-3,
    warp_fallback: bool = True,
) -> ECCResult:
    """Refine ``h_init`` so that cur(W(x)) aligns with ref(x).

    Args:
      ref, cur: (H, W) float32 grayscale images (working resolution).
      h_init: (3, 3) initial transform mapping ref pixel coords into cur
        (the inverse of the lock transform).
      warp_fallback: the warps take the projective gather outside the ~9°
        envelope (``warp_affine``'s ``projective_fallback``).  The JAX
        package's batched paths turn it off; then a transform outside the
        envelope merely fails to improve rho and ``h_init`` comes back.
    """
    hgt, wid = ref.shape
    dev = ref.device
    # statistics over an interior crop: the warp's border fill would
    # otherwise dominate the variance
    m = max(8, min(hgt, wid) // 12)

    def interior(img):
        return img[m:hgt - m, m:wid - m]

    ys = torch.arange(m, hgt - m, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(m, wid - m, dtype=torch.float32, device=dev)[None, :]

    t = interior(ref.float())
    zm_t = t - t.mean()
    t_norm2 = (zm_t * zm_t).sum()
    h_init = h_init.float()
    theta, tx, ty = _params_from_h(h_init)

    def warp(h):
        # warp_affine samples src at hinv·dst; iw(x) = cur(W x)
        return warp_affine(cur, _inv3x3(h), border_value=0.0,
                           projective_fallback=warp_fallback)

    def rho_of(iw_full):
        iw = interior(iw_full)
        zm_i = iw - iw.mean()
        denom = torch.sqrt(t_norm2 * (zm_i * zm_i).sum()) + 1e-12
        return (zm_t * zm_i).sum() / denom

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        iw_full = warp(_euclidean_h(theta, tx, ty))
        gx = interior(0.5 * (torch.roll(iw_full, -1, 1) - torch.roll(iw_full, 1, 1)))
        gy = interior(0.5 * (torch.roll(iw_full, -1, 0) - torch.roll(iw_full, 1, 0)))
        iw = interior(iw_full)
        zm_i = iw - iw.mean()

        # chain rule: d iw/d theta = grad(iw) . J x, J the rotation generator;
        # d iw/d t = grad(iw) . R
        c, s = torch.cos(theta), torch.sin(theta)
        g = torch.stack([-ys * gx + xs * gy,          # d/dtheta
                         c * gx + s * gy,             # d/dtx
                         -s * gx + c * gy]).reshape(3, -1)   # d/dty
        gg_inv = _inv3x3_f64(g @ g.T + 1e-6 * eye)
        gt = g @ zm_t.reshape(-1)
        gi = g @ zm_i.reshape(-1)

        num = (zm_i * zm_i).sum() - gi @ gg_inv @ gi
        den = (zm_t * zm_i).sum() - gt @ gg_inv @ gi
        lam = torch.where(den.abs() > 1e-8, num / den, 1.0)

        err = g @ (lam * zm_t - zm_i).reshape(-1)
        dp = gg_inv @ err
        dp = torch.where(torch.isfinite(dp), dp, 0.0)

        small = torch.sqrt((dp * dp).sum()) < eps
        upd = torch.where(done, 0.0, 1.0)
        theta, tx, ty = theta + upd * dp[0], tx + upd * dp[1], ty + upd * dp[2]
        done = done | small

    h_ref = _euclidean_h(theta, tx, ty)
    rho_final = rho_of(warp(h_ref))
    rho_init = rho_of(warp(h_init))
    improved = (rho_final >= rho_init) & torch.isfinite(h_ref).all()
    return ECCResult(h=torch.where(improved, h_ref, h_init),
                     rho=torch.maximum(rho_final, rho_init), valid=improved,
                     rho_init=rho_init)
