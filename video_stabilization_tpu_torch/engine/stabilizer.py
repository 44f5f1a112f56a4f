"""The per-frame stabilization step and the ``Stabilizer`` wrapper.

Port of ``video_stabilization_tpu/engine/stabilizer.py`` for the rigid
motion model with dense LK, cell GFTT and batched-hypothesis RANSAC:

  1. full-res BGR -> working-res gray + pyramid
  2. dense LK of the previous corners into this frame
  3. RANSAC similarity + isotropic-scale removal -> inter-frame T
  4. ring updates (frames circular, transforms rolled)
  5. smoothing homography Q
  6. lock homography: accumulated (anchor / advance / invert) or the ORB
     or SIFT registration lock against the captured reference, optionally
     refined by ECC (``engine/lock.py``)
  7. rotation split into translation and rotation locks
  8. mode switch
  9. translation rescale to full resolution, warp of the presentation frame
 10. GFTT for the next frame

The mode is a host ``int`` (``Stabilizer`` keeps it, the carry mirrors it as
a tensor), so branching on it never waits for the device.  The JAX
package's data-dependent ``lax.cond`` on small values become
``torch.where`` over both sides.  On a CUDA card a step reads nothing back
to the host: the warp kernel decides its envelope branch on the device
(``ops/affine_warp.py``).

Not ported yet, and refused with ``NotImplementedError``: the non-rigid
motion models, the host-estimator split (``ext_motion``) and the
``reference_compat`` referee paths.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine.lock import orb_lock, sift_lock
from video_stabilization_tpu_torch.engine.smoothing import smoothing_homography
from video_stabilization_tpu_torch.engine.state import EngineCarry, init_carry
from video_stabilization_tpu_torch.motion.homography import (
    HomographyParams,
    compose_homography,
    decompose_homography,
    remove_isotropic_scale,
)
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops.affine_warp import affine_envelope_ok, warp_affine
from video_stabilization_tpu_torch.ops.gftt import good_features_to_track
from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_bilinear
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.ops.warp import _inv3x3
from video_stabilization_tpu_torch.utils import prng
from video_stabilization_tpu_torch.utils.stage_profile import stage

ACCUM_MODES = (
    StabilizationMode.ACCUMULATED_FULL_LOCK,
    StabilizationMode.TRANSLATION_LOCK,
    StabilizationMode.ROTATION_LOCK,
)


def check_config(config: StabilizerConfig) -> None:
    """Raise for the configurations the port does not run yet."""
    if config.reference_compat:
        raise NotImplementedError(
            "reference_compat is not ported yet (ROADMAP Queue 1 item 14)")
    if config.ransac.method != "vmapped":
        raise NotImplementedError(
            f"ransac.method={config.ransac.method!r} is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    if config.ransac.motion_model != "rigid":
        raise NotImplementedError(
            f"ransac.motion_model={config.ransac.motion_model!r} is not ported yet "
            "(ROADMAP Queue 1 item 13)")


def _rotation_about(theta: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Rotation by -theta (y-down) about ``center`` as a 3x3 homography
    (cv::getRotationMatrix2D)."""
    zero2 = torch.zeros(theta.shape + (2,), dtype=theta.dtype, device=theta.device)
    p = HomographyParams(scale=torch.ones_like(theta), theta=-theta,
                         k=torch.ones_like(theta), delta=torch.zeros_like(theta),
                         t=zero2, v=zero2)
    return compose_homography(p, center)


def _fit_inter_frame(src, dst, status, key, config: StabilizerConfig, center):
    """RANSAC similarity fit of the tracked correspondences, then removal of
    the isotropic scale about the image centre (rigid model)."""
    ransac = estimate_similarity_ransac(src, dst, status, key, config.ransac)
    t_rigid, _ = remove_isotropic_scale(ransac.h, center)
    return ransac, t_rigid


def frame_keys(base_key: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_ransac, k_lock) of frame ``n``: ``fold_in(key, 2n)`` and
    ``fold_in(key, 2n + 1)``, as in the JAX package."""
    return prng.fold_in(base_key, n * 2), prng.fold_in(base_key, n * 2 + 1)


def stabilize_step(
    carry: EngineCarry,
    frame: torch.Tensor,
    config: StabilizerConfig,
    mode: int,
    ext_motion=None,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process one (Hf, Wf, C) uint8 BGR frame -> (carry', (output, valid)).

    ``mode`` is the host copy of ``carry.mode`` (``config.static_mode``
    overrides it).  ``carry.frames`` is updated in place."""
    if ext_motion is not None:
        raise NotImplementedError(
            "ext_motion (host estimator split) is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    check_config(config)
    if config.static_mode is not None:
        mode = int(config.static_mode)

    dev = frame.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = config.total_window
    future = config.future_frames
    wh, ww = config.working_size
    # small constants go up without a blocking copy (a pageable source is
    # staged by the CUDA runtime before the call returns)
    center = torch.tensor([ww / 2.0, wh / 2.0]).to(dev, non_blocking=True)
    scale_factor = torch.tensor(config.scale_factor).to(dev, non_blocking=True)
    eye = torch.eye(3, **f32)
    k_ransac, k_lock = frame_keys(carry.key, carry.n)

    # 1. working-res gray + pyramid (resize before gray, as the reference)
    with stage("gray"):
        gray = bgr_to_gray(resize_bilinear(frame.float(), wh, ww))
    with stage("pyramid"):
        pyr = build_pyramid(gray, config.lk.pyramid_levels)

    # 2-3. track + inter-frame motion
    with stage("lk_track"):
        tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev, carry.corners_mask,
                           config.lk)
    with stage("inter_frame_fit"):
        ransac, t_rigid = _fit_inter_frame(carry.corners_prev, tracked.points,
                                           tracked.status, k_ransac, config, center)
    is_first = carry.n == 0
    have_prev = carry.n >= 1
    t_new = torch.where(have_prev & ransac.valid, t_rigid, eye)

    # 4. ring updates
    n_after = carry.n + 1
    slot = torch.remainder(carry.n, w).long().view(1)
    frames = carry.frames
    frames.index_copy_(0, slot, frame.to(torch.uint8)[None])
    pushed_tr = torch.cat([carry.transforms[1:], t_new[None]], 0)
    pushed_tv = torch.cat([carry.tvalid[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    transforms = torch.where(have_prev, pushed_tr, carry.transforms)
    tvalid = torch.where(have_prev, pushed_tv, carry.tvalid)

    # window geometry
    length = torch.clamp(n_after, max=w)
    num_tr = length - 1
    zero_i = torch.zeros_like(length)
    pres = torch.where(length > future, length - future - 1, zero_i)
    pres_abs = torch.where(n_after > future, n_after - future - 1, zero_i)
    pres_slot = torch.remainder(pres_abs, w).long().view(1)
    pres_frame = frames.index_select(0, pres_slot)[0].float()

    # 5. smoothing
    with stage("smoothing"):
        h_smooth = smoothing_homography(transforms, tvalid, pres, num_tr,
                                        config.reference_compat)

    # 6. lock: a registration lock (ORB or SIFT), or the accumulated lock
    # (anchor on entry, then advance by the transform into the new
    # presentation frame)
    orb_ref, sift_ref, lock_prev_h = carry.orb_ref, carry.sift_ref, carry.lock_prev_h
    lock_matches = torch.zeros((), dtype=torch.int32, device=dev)
    accum_h = eye
    accum_active = torch.zeros((), dtype=torch.bool, device=dev)
    if mode == StabilizationMode.ORB_FULL_LOCK:
        with stage("orb_lock"):
            res = orb_lock(pres_frame, carry.orb_ref, carry.lock_prev_h, k_lock, config)
        h_lock, orb_ref, lock_prev_h, lock_matches = (res.h_lock, res.ref, res.prev_h,
                                                      res.n_matches)
    elif mode == StabilizationMode.SIFT_FULL_LOCK:
        with stage("sift_lock"):
            res = sift_lock(pres_frame, carry.sift_ref, carry.lock_prev_h, k_lock, config)
        h_lock, sift_ref, lock_prev_h, lock_matches = (res.h_lock, res.ref, res.prev_h,
                                                       res.n_matches)
    else:
        if mode in ACCUM_MODES:
            advanced = (n_after - 1 - future) >= 1
            tr_slot = ((transforms.shape[0] - num_tr) + pres - 1).clamp(0, w - 2)
            t_pres = transforms.index_select(0, tr_slot.long().view(1))[0]
            advanced_h = torch.where(advanced, torch.matmul(t_pres, carry.accum_h),
                                     carry.accum_h)
            accum_h = torch.where(carry.accum_active, advanced_h, eye)
            accum_active = torch.ones((), dtype=torch.bool, device=dev)
        h_lock = _inv3x3(accum_h)

    # 7. rotation split
    with stage("rotation_split"):
        lock_params, lock_ok = decompose_homography(h_lock, center)
    h_lock = torch.where(lock_ok, h_lock, eye)
    h_translation_lock = torch.matmul(_rotation_about(lock_params.theta, center), h_lock)
    h_rotation_lock = _rotation_about(-lock_params.theta, center)

    # 8. mode switch (host int)
    h_stabilize = {
        StabilizationMode.GLOBAL_SMOOTHING: h_smooth,
        StabilizationMode.ACCUMULATED_FULL_LOCK: h_lock,
        StabilizationMode.ORB_FULL_LOCK: h_lock,
        StabilizationMode.SIFT_FULL_LOCK: h_lock,
        StabilizationMode.TRANSLATION_LOCK: h_translation_lock,
        StabilizationMode.ROTATION_LOCK: h_rotation_lock,
    }[StabilizationMode(mode)]

    # 9. rescale to full resolution (affine block is scale-invariant) + warp
    h_scaled = h_stabilize.clone()
    h_scaled[0:2, 2] = h_stabilize[0:2, 2] / scale_factor
    avg_color = 0.5 * pres_frame.mean(dim=(0, 1))
    with stage("warp"):
        warped = warp_affine(pres_frame, h_scaled, border_value=avg_color,
                             projective_fallback=config.warp_projective_fallback)
    env_viol = carry.envelope_violations + (~affine_envelope_ok(h_scaled)).to(torch.int32)
    warped_u8 = torch.clamp(torch.round(warped), 0, 255).to(torch.uint8)

    # the first frame is returned unstabilized
    output = torch.where(is_first, frame.to(torch.uint8), warped_u8)
    out_valid = torch.ones((), dtype=torch.bool, device=dev)

    # 10. features for the next frame
    with stage("gftt"):
        corners = good_features_to_track(gray, config.gftt)

    new_carry = EngineCarry(
        frames=frames,
        transforms=transforms,
        tvalid=tvalid,
        pyr_prev=pyr,
        corners_prev=corners.points,
        corners_mask=corners.mask,
        n=n_after,
        mode=carry.mode,
        accum_h=accum_h,
        accum_active=accum_active,
        orb_ref=orb_ref,
        sift_ref=sift_ref,
        lock_prev_h=lock_prev_h,
        last_h=h_stabilize,
        last_inliers=ransac.num_inliers,
        last_lock_matches=lock_matches,
        envelope_violations=env_viol,
        key=carry.key,
    )
    return new_carry, (output, out_valid)


class Stabilizer:
    """One stream: construct with a config, feed frames one at a time,
    switch modes at runtime (the reference's public API).  It runs on the
    CUDA card unless ``device`` names the CPU; with no card, asking for CUDA
    raises rather than falls back."""

    def __init__(self, config: StabilizerConfig,
                 mode: StabilizationMode = StabilizationMode.GLOBAL_SMOOTHING,
                 seed: int = 0, *, device="cuda"):
        # f32 everywhere: TF32 would cost three decimal digits in the filters
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Stabilizer: device {device!r} requested but CUDA "
                               "is not available")
        check_config(config)
        self.config = config
        self._mode = int(mode)
        self.carry = init_carry(config, self._mode, prng.key(seed), self.device)

    def set_stabilization_mode(self, mode: StabilizationMode) -> None:
        """Switch modes; clears lock state, keeps the frame/transform window."""
        dev = self.device
        eye = torch.eye(3, dtype=torch.float32, device=dev)

        def cleared(ref):
            return ref.__class__(points=torch.zeros_like(ref.points),
                                 desc=torch.zeros_like(ref.desc),
                                 mask=torch.zeros_like(ref.mask),
                                 gray=torch.zeros_like(ref.gray),
                                 is_set=torch.zeros_like(ref.is_set))

        self._mode = int(mode)
        self.carry = dataclasses.replace(
            self.carry,
            mode=torch.tensor(self._mode, dtype=torch.int32, device=dev),
            accum_h=eye,
            accum_active=torch.zeros((), dtype=torch.bool, device=dev),
            orb_ref=cleared(self.carry.orb_ref),
            sift_ref=cleared(self.carry.sift_ref),
            lock_prev_h=eye.clone(),
            last_lock_matches=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _as_frame(self, frame) -> torch.Tensor:
        if isinstance(frame, np.ndarray):
            frame = torch.from_numpy(np.require(frame, requirements=("C", "W")))
        return frame.to(self.device)

    def stabilize_frame(self, frame) -> torch.Tensor:
        """Feed one (Hf, Wf, C) uint8 BGR frame (array or tensor); returns the
        stabilized, delayed output frame on the device."""
        self.carry, (output, _) = stabilize_step(self.carry, self._as_frame(frame),
                                                 self.config, self._mode)
        return output

    def stabilize_clip(self, frames) -> torch.Tensor:
        """Feed a (T, Hf, Wf, C) clip frame by frame; returns the outputs."""
        return torch.stack([self.stabilize_frame(f) for f in frames])

    @property
    def total_frame_window_size(self) -> int:
        return self.config.total_window
