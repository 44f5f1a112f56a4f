"""The ORB registration lock (ORB_FULL_LOCK).

Port of the Hamming path of ``video_stabilization_tpu/engine/lock.py``
(``_registration_lock``, ``orb_lock``; ``sift_lock`` raises; reference:
src/stabilizer.cpp:440-788).  The presentation frame is registered directly
against a reference frame captured at mode entry: INTER_NEAREST downscale,
gray, the median/sharpen/CLAHE chain, ORB, Hamming kNN with the ratio
test, RANSAC similarity, isotropic-scale removal, inverse.  When detection,
matching or the fit fails, the last good lock transform is kept (the
reference's sticky fallback, held per stream in the carry).

The JAX package branches with ``lax.cond`` on whether a reference is set.
Here both branches' values are computed and ``torch.where`` selects, so the
branch never reads the device: with no reference the register side matches
nothing, and only the capture side's values are kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from video_stabilization_tpu_torch.config import StabilizerConfig
from video_stabilization_tpu_torch.engine.state import RegistrationRef
from video_stabilization_tpu_torch.motion.homography import remove_isotropic_scale
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops.filters import preprocess_for_registration
from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_nearest
from video_stabilization_tpu_torch.ops.match import match_hamming_knn
from video_stabilization_tpu_torch.ops.orb import orb_detect_and_compute
from video_stabilization_tpu_torch.ops.warp import _inv3x3
from video_stabilization_tpu_torch.utils.stage_profile import stage


@dataclass
class LockResult:
    h_lock: torch.Tensor     # (3, 3) current -> reference
    ref: RegistrationRef     # the reference, captured on this frame if it was unset
    prev_h: torch.Tensor     # (3, 3) the updated sticky fallback
    n_matches: torch.Tensor  # () int32 matches that passed the ratio test


def _registration_lock(feats_points, feats_desc, feats_mask, proc_gray,
                       ref: RegistrationRef, prev_h: torch.Tensor, key: torch.Tensor,
                       config: StabilizerConfig, center: torch.Tensor) -> LockResult:
    """Register the frame's features against ``ref``, or capture them as the
    reference when ``ref`` is unset (then the lock and the fallback reset to
    the identity)."""
    if config.ecc.enabled:
        raise NotImplementedError(
            "ecc.enabled (ECC refinement of the lock) is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    with stage("match"):
        m = match_hamming_knn(ref.desc, ref.mask, feats_desc, feats_mask,
                              config.orb.lowe_ratio)
    dst = feats_points[m.idx]
    with stage("lock_ransac"):
        res = estimate_similarity_ransac(
            ref.points, dst, m.valid, key, config.ransac,
            inlier_threshold=config.ransac.lock_inlier_threshold)
    h_rigid, rigid_ok = remove_isotropic_scale(res.h, center)
    n_good = m.valid.to(torch.int32).sum()
    enough = ((feats_mask.to(torch.int32).sum() >= config.ransac.min_points)
              & (n_good >= config.ransac.min_points))
    ok = res.valid & rigid_ok & enough
    h_reg = torch.where(ok, _inv3x3(h_rigid), prev_h)

    is_set = ref.is_set
    eye = torch.eye(3, dtype=torch.float32, device=prev_h.device)
    h = torch.where(is_set, h_reg, eye)
    new_ref = RegistrationRef(
        points=torch.where(is_set, ref.points, feats_points),
        desc=torch.where(is_set, ref.desc, feats_desc),
        mask=torch.where(is_set, ref.mask, feats_mask),
        gray=torch.where(is_set, ref.gray, proc_gray),
        is_set=torch.ones_like(is_set),
    )
    return LockResult(h_lock=h, ref=new_ref, prev_h=h,
                      n_matches=torch.where(is_set, n_good, torch.zeros_like(n_good)))


def orb_lock(pres_frame: torch.Tensor, ref: RegistrationRef, prev_h: torch.Tensor,
             key: torch.Tensor, config: StabilizerConfig) -> LockResult:
    """ORB registration lock of the (Hf, Wf, C) float presentation frame:
    INTER_NEAREST downscale to the working size, gray, preprocessing, ORB
    with the relative-size filter, then :func:`_registration_lock`."""
    wh, ww = config.working_size
    center = torch.tensor([ww / 2.0, wh / 2.0]).to(pres_frame.device, non_blocking=True)
    with stage("nearest_downscale"):
        gray = bgr_to_gray(resize_nearest(pres_frame.float(), wh, ww))
    with stage("preprocess"):
        proc = preprocess_for_registration(gray, config.preprocess.clahe_clip_limit,
                                           config.preprocess.clahe_tiles,
                                           config.preprocess.median_ksize)
    with stage("orb_detect"):
        feats = orb_detect_and_compute(proc, config.orb)
    return _registration_lock(feats.points, feats.desc, feats.mask, proc, ref, prev_h,
                              key, config, center)


def sift_lock(pres_frame: torch.Tensor, ref: RegistrationRef, prev_h: torch.Tensor,
              key: torch.Tensor, config: StabilizerConfig) -> LockResult:
    """The SIFT registration lock: not ported yet."""
    raise NotImplementedError("sift_lock is not ported yet (ROADMAP Queue 1 item 12)")
