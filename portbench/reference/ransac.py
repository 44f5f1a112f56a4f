"""RANSAC similarity estimation with a fixed batch of hypotheses.

Port of ``video_stabilization_tpu/motion/ransac.py``.  All hypotheses are
drawn up front from the same threefry stream as the JAX package
(``utils/prng.py``), solved in one batch, scored as one (hypotheses x points)
broadcast and picked by a first-index argmax; the inlier set is then refit a
fixed number of times, by the similarity LS or by a ``refit_fn`` of another
motion family (``models/motion_models.py``).  No host synchronisation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.config import RansacConfig
from portbench.reference.homography import identity_homography
from portbench.reference.similarity import (
    fit_similarity_masked,
    similarity_from_2pt,
    transform_points,
)
from portbench.reference import prng


@dataclass
class RansacResult:
    h: torch.Tensor            # (..., 3, 3) similarity (last row 0, 0, 1)
    valid: torch.Tensor        # (...) bool — False => h is identity
    inliers: torch.Tensor      # (..., N) bool
    num_inliers: torch.Tensor  # (...) int32


def _take_pairs(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per batch entry: (..., N, D) by (..., H, 2) indices
    -> (..., H, 2, D)."""
    flat = idx.flatten(-2)
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + x.shape[-1:]))
    return out.unflatten(-2, idx.shape[-2:])


def estimate_similarity_ransac(
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    key: torch.Tensor,
    config: RansacConfig = RansacConfig(),
    inlier_threshold: float | None = None,
    refit_fn=None,
) -> RansacResult:
    """Robust similarity fit of masked (..., N, 2) correspondences ``src ->
    dst`` with hypotheses drawn from the (..., 2) threefry ``key``: each
    leading index is one independent problem with its own key, and gives
    what a call on that slice alone gives.

    ``refit_fn(src, dst, weights) -> (h, valid)`` refines the inlier set
    in place of the similarity LS (LO-RANSAC: similarity hypotheses select
    the inliers, the configured motion family refits on them)."""
    if refit_fn is None:
        refit_fn = fit_similarity_masked
    dtype = src.dtype
    thresh = inlier_threshold if inlier_threshold is not None else config.inlier_threshold
    thresh2 = thresh * thresh
    maskf = mask.to(dtype)
    num_valid = mask.to(torch.int64).sum(-1)
    enough = num_valid >= config.min_points

    # valid lanes first (stable), then two distinct slots modulo num_valid
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    bits = prng.bits(key, config.num_hypotheses)                # (..., H)
    nv = num_valid.clamp(min=2)[..., None]
    j1 = (bits & 0xFFFF) % nv
    j2 = (j1 + 1 + (bits >> 16) % (nv - 1)) % nv
    pairs = torch.stack([j1, j2], -1)                           # (..., H, 2)
    idx = torch.gather(order, -1, pairs.flatten(-2)).unflatten(-1, pairs.shape[-2:])

    h_hyp, hyp_valid = similarity_from_2pt(_take_pairs(src, idx),
                                           _take_pairs(dst, idx))  # (..., H, 3, 3)

    proj = transform_points(h_hyp, src[..., None, :, :])        # (..., H, N, 2)
    resid2 = ((proj - dst[..., None, :, :]) ** 2).sum(-1)
    inlier = (resid2 < thresh2) & mask[..., None, :]
    counts = inlier.to(torch.int64).sum(-1)
    counts = torch.where(hyp_valid, counts, torch.full_like(counts, -1))
    # first maximum; gathering keeps the pick on the device (indexing with a
    # 0-d tensor would read it on the host)
    best = torch.argmax(counts, -1, keepdim=True)               # (..., 1)
    best_count = counts.gather(-1, best)[..., 0]
    h_cur = torch.take_along_dim(h_hyp, best[..., None, None], dim=-3)[..., 0, :, :]
    inl = torch.take_along_dim(inlier, best[..., None], dim=-2)[..., 0, :]
    for _ in range(config.refine_iters):
        h_new, fit_valid = refit_fn(src, dst, inl.to(dtype) * maskf)
        h_cur = torch.where(fit_valid[..., None, None], h_new, h_cur)
        r2 = ((transform_points(h_cur, src) - dst) ** 2).sum(-1)
        inl = (r2 < thresh2) & mask

    final_count = inl.to(torch.int32).sum(-1)
    ok = enough & (best_count >= config.min_points) & (final_count >= 3)
    ok = ok & torch.isfinite(h_cur).flatten(-2).all(-1)
    eye = identity_homography((), dtype, src.device)
    return RansacResult(
        h=torch.where(ok[..., None, None], h_cur, eye),
        valid=ok,
        inliers=inl & ok[..., None],
        num_inliers=torch.where(ok, final_count, torch.zeros_like(final_count)),
    )
