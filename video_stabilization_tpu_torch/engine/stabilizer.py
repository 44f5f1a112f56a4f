"""The per-frame stabilization step and the ``Stabilizer`` wrapper.

Port of ``video_stabilization_tpu/engine/stabilizer.py``:

  1. full-res BGR -> working-res gray (cv2's exact u8 gray under
     ``reference_compat``) + pyramid
  2. LK of the previous corners into this frame (``lk.method``)
  3. RANSAC similarity + isotropic-scale removal -> inter-frame T (rigid),
     or the similarity hypotheses' inliers refit by the configured motion
     model (``models/motion_models.py``); or the motion a host estimator
     computed (``ext_motion``)
  4. ring updates (frames circular, transforms rolled)
  5. smoothing homography Q
  6. lock homography: accumulated (anchor / advance / invert) or the ORB
     or SIFT registration lock against the captured reference, optionally
     refined by ECC (``engine/lock.py``)
  7. rotation split into translation and rotation locks
  8. mode switch
  9. translation rescale to full resolution, warp of the presentation frame
 10. GFTT for the next frame (cv2's exact list under ``reference_compat``;
     empty lanes for ``gftt.selection="host"``, which the host fills)

The mode is a host ``int`` (``Stabilizer`` keeps it, the carry mirrors it as
a tensor), so branching on it never waits for the device.  The step
factories :func:`make_step_fn` and :func:`make_scan_fn` keep the JAX
signatures ``(carry, frame)`` and ``(carry, frames)``: they take the mode
from ``config.static_mode`` when it is set, else from one read of
``carry.mode`` per call (on the card, the one host sync of the call).  The JAX
package's data-dependent ``lax.cond`` on small values become
``torch.where`` over both sides.  On a CUDA card a step reads nothing back
to the host: the warp kernel decides its envelope branch on the device
(``ops/affine_warp.py``).  The exceptions are the referee's stages, which
read to the host by design: cv2exact GFTT's fixpoint (one read every
``ops.gftt.GREEDY_CHECK_EVERY`` rounds) and, with ``ransac.method=
"cv2exact"``, ``Stabilizer``'s host-estimator split (:meth:`Stabilizer.
stabilize_frame`).  The homography model warps its output through
``ops/warp.py::warp_perspective``; the other models through the warp kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine.lock import orb_lock, sift_lock
from video_stabilization_tpu_torch.engine.smoothing import smoothing_homography
from video_stabilization_tpu_torch.engine.state import EngineCarry, init_carry, map_carry
from video_stabilization_tpu_torch.engine.step_graph import GraphCache, StepGraph
from video_stabilization_tpu_torch.motion.homography import (
    HomographyParams,
    compose_homography,
    decompose_homography,
    remove_isotropic_scale,
)
from video_stabilization_tpu_torch.models.motion_models import MotionModel, fit_motion
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops.affine_warp import affine_envelope_ok, warp_affine
from video_stabilization_tpu_torch.ops.gftt import Corners, good_features_to_track
from video_stabilization_tpu_torch.ops.image import (
    bgr_to_gray, gray_u8_cv2exact, resize_bilinear)
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.ops.warp import _inv3x3, warp_perspective
from video_stabilization_tpu_torch.utils import prng
from video_stabilization_tpu_torch.utils.stage_profile import stage

ACCUM_MODES = (
    StabilizationMode.ACCUMULATED_FULL_LOCK,
    StabilizationMode.TRANSLATION_LOCK,
    StabilizationMode.ROTATION_LOCK,
)



def accumulating_modes(config: StabilizerConfig) -> tuple:
    """The modes that anchor and advance the accumulated lock: under
    ``reference_compat`` only ACCUMULATED_FULL_LOCK, since the reference's
    translation and rotation locks are no-ops (H_lock identity,
    src/stabilizer.cpp:790)."""
    if config.reference_compat:
        return (StabilizationMode.ACCUMULATED_FULL_LOCK,)
    return ACCUM_MODES


def working_gray(frames: torch.Tensor, config: StabilizerConfig) -> torch.Tensor:
    """(..., Hf, Wf, C) u8 frames -> (..., wh, ww) f32 working gray: cv2's
    exact u8 gray under ``reference_compat`` (a ±1 level perturbs the
    referee's corner list), else resize then gray, the reference's order."""
    wh, ww = config.working_size
    if config.reference_compat:
        return gray_u8_cv2exact(frames, wh, ww)
    return bgr_to_gray(resize_bilinear(frames.float(), wh, ww))


def corner_config(config: StabilizerConfig):
    """The next frame's corner detector: cv2's exact list under
    ``reference_compat`` (corner-set selection dominates the drift against
    the reference), else ``config.gftt``."""
    if config.reference_compat and config.gftt.selection != "cv2exact":
        return dataclasses.replace(config.gftt, selection="cv2exact")
    return config.gftt


def next_corners(gray: torch.Tensor, config: StabilizerConfig) -> Corners:
    """The streaming step's corners for the next frame on (..., wh, ww)
    grays: with ``gftt.selection="host"`` empty lanes (the host injects its
    element-exact list after the step, ``Stabilizer.stabilize_frame``),
    else :func:`corner_config`'s detector."""
    if config.gftt.selection == "host":
        lead = gray.shape[:-2]
        nf = config.gftt.max_features
        zeros = torch.zeros(lead + (nf,), dtype=torch.float32, device=gray.device)
        return Corners(points=torch.zeros(lead + (nf, 2), dtype=torch.float32,
                                          device=gray.device),
                       response=zeros, mask=torch.zeros_like(zeros, dtype=torch.bool))
    return good_features_to_track(gray, corner_config(config))


def _rotation_about(theta: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Rotation by -theta (y-down) about ``center`` as a 3x3 homography
    (cv::getRotationMatrix2D)."""
    zero2 = torch.zeros(theta.shape + (2,), dtype=theta.dtype, device=theta.device)
    p = HomographyParams(scale=torch.ones_like(theta), theta=-theta,
                         k=torch.ones_like(theta), delta=torch.zeros_like(theta),
                         t=zero2, v=zero2)
    return compose_homography(p, center)


def _fit_inter_frame(src, dst, status, key, config: StabilizerConfig, center):
    """RANSAC fit of the tracked correspondences -> (result, inter-frame T).
    Rigid: the similarity fit, then removal of the isotropic scale about the
    image centre.  Other models: similarity hypotheses select the inliers,
    the configured model refits on them (LO-RANSAC)."""
    if config.ransac.motion_model == "rigid":
        ransac = estimate_similarity_ransac(src, dst, status, key, config.ransac)
        t_rigid, _ = remove_isotropic_scale(ransac.h, center)
        return ransac, t_rigid
    model = MotionModel(config.ransac.motion_model)
    ransac = estimate_similarity_ransac(
        src, dst, status, key, config.ransac,
        refit_fn=lambda s, d, w: fit_motion(model, s, d, w, center))
    return ransac, ransac.h


def frame_keys(base_key: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_ransac, k_lock) of frame ``n``: ``fold_in(key, 2n)`` and
    ``fold_in(key, 2n + 1)``, as in the JAX package."""
    return prng.fold_in(base_key, n * 2), prng.fold_in(base_key, n * 2 + 1)


def stabilized_outputs(mode, h_smooth, h_lock, pres_frames, frames, is_first, center,
                       scale_factor, projective_fallback: bool, homography: bool = False):
    """The step's tail over any leading dims (none for the streaming step,
    (S, K) for a chunk of S streams): rotation split of ``h_lock``, the
    mode's stabilizing homography, its rescale to full resolution, and one
    batched warp of all (..., Hf, Wf, C) presentation frames, each with the
    border 0.5 · its mean colour; where ``is_first``, the new frame in
    ``frames`` passes through unwarped.  With ``homography`` (the homography
    motion model) the projective row rescales too and the frames go through
    ``warp_perspective``, which has no envelope.  ``mode`` is a host int,
    or an int32 tensor that broadcasts against the leading dims (the (S, 1)
    modes of a batch of streams in mixed modes, on the device): each item
    then takes its own mode's homography by ``torch.where``.  Returns
    (h_stab (..., 3, 3), outputs (..., Hf, Wf, C) u8, (...) bool: ``h_stab``
    outside the warp kernel's envelope)."""
    eye = torch.eye(3, dtype=torch.float32, device=h_lock.device)
    with stage("rotation_split"):
        lock_params, lock_ok = decompose_homography(h_lock, center)
    h_lock = torch.where(lock_ok[..., None, None], h_lock, eye)

    def translation_lock():
        return torch.matmul(_rotation_about(lock_params.theta, center), h_lock)

    def rotation_lock():
        return _rotation_about(-lock_params.theta, center)

    if isinstance(mode, torch.Tensor):      # each item its own mode, on the device
        m = mode[..., None, None]
        h_stab = torch.where(
            m == int(StabilizationMode.GLOBAL_SMOOTHING), h_smooth, torch.where(
                m == int(StabilizationMode.TRANSLATION_LOCK), translation_lock(), torch.where(
                    m == int(StabilizationMode.ROTATION_LOCK), rotation_lock(), h_lock)))
    else:
        h_stab = {StabilizationMode.GLOBAL_SMOOTHING: lambda: h_smooth,
                  StabilizationMode.TRANSLATION_LOCK: translation_lock,
                  StabilizationMode.ROTATION_LOCK: rotation_lock,
                  }.get(StabilizationMode(int(mode)), lambda: h_lock)()

    # the affine block is scale-invariant: the translation divides by the
    # factor, a projective row multiplies by it
    h_scaled = h_stab.clone()
    h_scaled[..., 0:2, 2] = h_stab[..., 0:2, 2] / scale_factor
    with stage("warp"):
        pres = pres_frames.reshape((-1,) + pres_frames.shape[-3:]).float()
        border = 0.5 * pres.mean(dim=(1, 2))
        if homography:
            h_scaled[..., 2, 0:2] = h_scaled[..., 2, 0:2] * scale_factor
            outside = torch.zeros(h_scaled.shape[:-2], dtype=torch.bool, device=h_scaled.device)
            out = warp_perspective(pres, h_scaled.reshape(-1, 3, 3), None, border)
        else:
            outside = ~affine_envelope_ok(h_scaled)
            out = warp_affine(pres, h_scaled.reshape(-1, 3, 3), border_value=border,
                              projective_fallback=projective_fallback)
        warped_u8 = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    outputs = torch.where(is_first[..., None, None, None], frames.to(torch.uint8),
                          warped_u8.reshape(pres_frames.shape))
    return h_stab, outputs, outside


def step_constants(config: StabilizerConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(center (2,) f32, scale_factor () f32) of ``config`` on ``device``:
    the working image's centre and the working-to-full scale.  They go up
    without a blocking copy (a pageable source is staged by the CUDA
    runtime before the call returns)."""
    wh, ww = config.working_size
    return (torch.tensor([ww / 2.0, wh / 2.0]).to(device, non_blocking=True),
            torch.tensor(config.scale_factor).to(device, non_blocking=True))


def stabilize_step(
    carry: EngineCarry,
    frame: torch.Tensor,
    config: StabilizerConfig,
    mode: int,
    ext_motion=None,
    center: torch.Tensor | None = None,
    scale_factor: torch.Tensor | None = None,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process one (Hf, Wf, C) uint8 BGR frame -> (carry', (output, valid)).

    ``mode`` is the host copy of ``carry.mode`` (``config.static_mode``
    overrides it).  ``carry.frames`` is updated in place.

    ``ext_motion``: an optional ``(h (3, 3) f32, valid () bool, n_inliers ()
    int32)`` inter-frame rigid motion computed by a host estimator (the
    cv2exact RANSAC replica, ``motion/cv2_ransac.py``); given, the step
    skips its own LK and RANSAC stages.

    ``center`` and ``scale_factor``: the working image's (2,) f32 centre and
    the () f32 working-to-full scale on the frame's device, as
    :func:`step_constants` makes them once; without them the step uploads
    both from the host, which a CUDA graph's capture refuses."""
    if config.static_mode is not None:
        mode = int(config.static_mode)

    dev = frame.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = config.total_window
    future = config.future_frames
    if center is None or scale_factor is None:
        center, scale_factor = step_constants(config, dev)
    eye = torch.eye(3, **f32)
    k_ransac, k_lock = frame_keys(carry.key, carry.n)

    # 1. working-res gray + pyramid
    with stage("gray"):
        gray = working_gray(frame, config)
    with stage("pyramid"):
        pyr = build_pyramid(gray, config.lk.pyramid_levels)

    # 2-3. track + inter-frame motion, unless a host estimator gave it
    if ext_motion is None:
        with stage("lk_track"):
            tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev, carry.corners_mask,
                               config.lk)
        with stage("inter_frame_fit"):
            ransac, t_rigid = _fit_inter_frame(carry.corners_prev, tracked.points,
                                               tracked.status, k_ransac, config, center)
        fit_valid, n_inliers = ransac.valid, ransac.num_inliers
    else:
        t_rigid, fit_valid, n_inliers = ext_motion
    is_first = carry.n == 0
    have_prev = carry.n >= 1
    t_new = torch.where(have_prev & fit_valid, t_rigid, eye)

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
        if mode in accumulating_modes(config):
            advanced = (n_after - 1 - future) >= 1
            tr_slot = ((transforms.shape[0] - num_tr) + pres - 1).clamp(0, w - 2)
            t_pres = transforms.index_select(0, tr_slot.long().view(1))[0]
            advanced_h = torch.where(advanced, torch.matmul(t_pres, carry.accum_h),
                                     carry.accum_h)
            accum_h = torch.where(carry.accum_active, advanced_h, eye)
            accum_active = torch.ones((), dtype=torch.bool, device=dev)
        h_lock = _inv3x3(accum_h)

    # 7-9. rotation split, mode switch, rescale and warp
    h_stabilize, output, outside = stabilized_outputs(
        mode, h_smooth, h_lock, pres_frame, frame, is_first, center, scale_factor,
        config.warp_projective_fallback, config.ransac.motion_model == "homography")
    env_viol = carry.envelope_violations + outside.to(torch.int32)
    out_valid = torch.ones((), dtype=torch.bool, device=dev)

    # 10. features for the next frame
    with stage("gftt"):
        corners = next_corners(gray, config)

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
        last_inliers=n_inliers,
        last_lock_matches=lock_matches,
        envelope_violations=env_viol,
        key=carry.key,
    )
    return new_carry, (output, out_valid)


def host_mode(carry: EngineCarry, config: StabilizerConfig) -> int:
    """The mode a step of ``carry`` runs: ``config.static_mode`` when set,
    else ``carry.mode`` read to the host (a sync when the carry is on the
    card)."""
    if config.static_mode is not None:
        return int(config.static_mode)
    return int(carry.mode)


@functools.lru_cache(maxsize=32)
def make_step_fn(config: StabilizerConfig) -> Callable:
    """(carry, frame (Hf, Wf, C) u8) -> (carry, (output, valid)): the step
    specialized to ``config``, as the JAX package's ``make_step_fn``.  The
    mode is :func:`host_mode`'s: one read of ``carry.mode`` per call unless
    ``config.static_mode`` is set.  ``carry.frames`` is updated in place
    (the JAX step donates the carry)."""

    def step(carry: EngineCarry, frame: torch.Tensor):
        return stabilize_step(carry, frame, config, host_mode(carry, config))

    return step


@functools.lru_cache(maxsize=32)
def make_scan_fn(config: StabilizerConfig) -> Callable:
    """(carry, frames (T, Hf, Wf, C) u8) -> (carry, (outputs (T, Hf, Wf,
    C), valid (T,))): the step over a clip, frame by frame on the carry's
    device, as the JAX package's ``lax.scan`` of it.  The mode is read once
    per clip (:func:`host_mode`); the step keeps ``carry.mode``."""

    def scan(carry: EngineCarry, frames):
        frames = torch.as_tensor(frames).to(carry.frames.device)
        mode = host_mode(carry, config)
        outputs, valid = [], []
        for frame in frames:
            carry, (out, ok) = stabilize_step(carry, frame, config, mode)
            outputs.append(out)
            valid.append(ok)
        return carry, (torch.stack(outputs), torch.stack(valid))

    return scan


@functools.lru_cache(maxsize=32)
def make_track_fn(config: StabilizerConfig) -> Callable:
    """(carry, frame) -> (tracked points (N, 2), status (N,)): the gray,
    pyramid and LK prefix of the step, for the host-estimator split.  The
    step derives its gray and pyramid again; the duplicate is confined to
    the referee, where exactness, not speed, is the point."""

    def track(carry: EngineCarry, frame: torch.Tensor):
        with stage("gray"):
            gray = working_gray(frame, config)
        with stage("pyramid"):
            pyr = build_pyramid(gray, config.lk.pyramid_levels)
        with stage("lk_track"):
            tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev,
                               carry.corners_mask, config.lk)
        return tracked.points, tracked.status

    return track


@functools.lru_cache(maxsize=32)
def make_step_ext_fn(config: StabilizerConfig) -> Callable:
    """(carry, frame, ext_motion) -> (carry, (output, valid)): the step with
    the inter-frame motion from a host estimator (``stabilize_step``'s
    ``ext_motion``), the mode as :func:`host_mode` gives it."""

    def step_ext(carry: EngineCarry, frame: torch.Tensor, ext_motion):
        return stabilize_step(carry, frame, config, host_mode(carry, config), ext_motion)

    return step_ext


REGISTRATION_MODES = (StabilizationMode.ORB_FULL_LOCK, StabilizationMode.SIFT_FULL_LOCK)

# what Stabilizer.stabilize_frame did since the last reset_step_counters():
# its calls, the calls that replayed a CUDA graph of the step, and the
# graphs it captured; host counts, read without a sync
step_counters: dict = {}


def reset_step_counters() -> None:
    step_counters.clear()
    step_counters.update(calls=0, replays=0, captures=0)


reset_step_counters()


def step_replays(config: StabilizerConfig, device) -> bool:
    """Whether ``Stabilizer`` replays the step of ``config`` on ``device``
    as a CUDA graph (in every mode but the registration locks): on a CUDA
    card, unless a stage reads the device to the host, which capture
    refuses: the referee's host estimator (``ransac.method="cv2exact"``),
    host GFTT and cv2's exact greedy corners (``gftt.selection`` "host" or
    "cv2exact", or ``reference_compat``)."""
    return (torch.device(device).type == "cuda" and config.ransac.method != "cv2exact"
            and corner_config(config).selection not in ("host", "cv2exact"))


def _as_tensor(frame) -> torch.Tensor:
    if isinstance(frame, np.ndarray):
        return torch.from_numpy(np.require(frame, requirements=("C", "W")))
    return frame


def _copy_carry(dst: EngineCarry, src: EngineCarry) -> None:
    """Copy each tensor of ``src`` into ``dst``'s, but those they share."""
    map_carry(lambda d, s: d if s is d else d.copy_(s), dst, src)


class Stabilizer:
    """One stream: construct with a config, feed frames one at a time,
    switch modes at runtime (the reference's public API).  It runs on the
    CUDA card unless ``device`` names the CPU; with no card, asking for CUDA
    raises rather than falls back.

    With ``ransac.method="cv2exact"`` (the reference-compat referee) each
    frame runs the host-estimator split: the track prefix on the device,
    the bit-exact ``cv2.estimateAffinePartial2D`` replica on the host
    (``motion/cv2_ransac.py``), then the step with that motion; with
    ``gftt.selection="host"`` too, the element-exact corner list of
    ``ops/gftt_host.py`` replaces the step's corners.  Host traffic per
    frame, by design: one read of the previous corners, tracked points and
    status together; the motion's upload; with host GFTT, a read of the
    frame (none when it is given as a numpy array) and the corners' upload.
    :attr:`host_reads` counts the reads."""

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
        self.config = config
        if config.ransac.method == "cv2exact" and config.ransac.motion_model != "rigid":
            raise ValueError("cv2exact RANSAC supports the rigid model only")
        self._track = make_track_fn(config) if config.ransac.method == "cv2exact" else None
        self.host_reads = 0
        self._mode = int(mode)
        self.carry = init_carry(config, self._mode, prng.key(seed), self.device)
        # the step's CUDA graphs by (mode, frame shape, frame dtype), the
        # carry they read and write, and their input frames by shape and dtype
        self._graphs = GraphCache() if step_replays(config, self.device) else None
        self._constants = step_constants(config, self.device) if self._graphs is not None else None
        self._static = None
        self._inputs: dict = {}

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

    @property
    def mode(self) -> int:
        """The host mode the next step runs (``carry.mode``'s host copy)."""
        return self._mode

    def resume(self, path: str) -> None:
        """Restore the carry saved by ``engine.checkpoint.save_carry`` (of
        either package) and take the host mode from its ``mode``."""
        from video_stabilization_tpu_torch.engine.checkpoint import load_carry

        self.carry = load_carry(path, self.carry)
        self._mode = int(self.carry.mode)

    def _as_frame(self, frame) -> torch.Tensor:
        return _as_tensor(frame).to(self.device)

    def stabilize_frame(self, frame) -> torch.Tensor:
        """Feed one (Hf, Wf, C) uint8 BGR frame (array or tensor); returns the
        stabilized, delayed output frame on the device.  Stage ranges: the
        frame's upload (``input_h2d``), then the rest (``step``).

        Where :func:`step_replays` holds, in a mode other than the
        registration locks, the step is a CUDA graph captured per (mode,
        frame shape, frame dtype) at the key's second call
        (``engine/step_graph.py``): the frame is copied into the graph's
        input, the replay runs under ``step_replay`` and the output is a
        fresh copy.  :attr:`carry` then stays one object whose tensors each
        replay overwrites, so a carry read before a call is no snapshot of
        it after the call (its ``frames`` ring never was); a carry put in
        its place (a mode switch, :meth:`resume`) is copied in before the
        next replay.  :data:`step_counters` counts the calls, replays and
        captures."""
        step_counters["calls"] += 1
        src = _as_tensor(frame)
        pinned = self.config.static_mode
        mode = self._mode if pinned is None else int(pinned)
        key = None
        if self._graphs is not None and mode not in REGISTRATION_MODES:
            key = (mode, tuple(src.shape), src.dtype)
        with stage("input_h2d"):
            f = self._static_input(src) if key else src.to(self.device)
        graph = self._graphs.get(key, lambda: self._capture(key[0], f)) if key else None
        if graph is not None:
            with stage("step_replay"):
                self._adopt_carry()
                output = graph.replay().clone()
            step_counters["replays"] += 1
            return output
        with stage("step"):
            if self._track is None:
                self.carry, (output, _) = stabilize_step(self.carry, f, self.config,
                                                         self._mode)
                return output
            self.carry, (output, _) = stabilize_step(self.carry, f, self.config, self._mode,
                                                     self._host_motion(f))
            if self.config.gftt.selection == "host":
                self._inject_host_corners(frame)
            return output

    def _static_input(self, src: torch.Tensor) -> torch.Tensor:
        """``src`` copied into the graphs' device input of its shape and
        dtype."""
        key = (tuple(src.shape), src.dtype)
        buf = self._inputs.get(key)
        if buf is None:
            buf = self._inputs[key] = torch.empty(src.shape, dtype=src.dtype,
                                                  device=self.device)
        return buf.copy_(src)

    def _adopt_carry(self) -> EngineCarry:
        """:attr:`carry` as the graphs' carry, whose tensors stay put: at
        first a copy of it that shares its frame ring, later the same
        tensors refilled from whatever carry took its place (an eager step,
        a mode switch, a resume)."""
        if self._static is None:
            ring = self.carry.frames
            self._static = map_carry(lambda x: x if x is ring else x.clone(), self.carry)
        elif self.carry is not self._static:
            _copy_carry(self._static, self.carry)
        self.carry = self._static
        return self._static

    def _capture(self, mode: int, f: torch.Tensor) -> StepGraph:
        """The step in ``mode`` on the graphs' input ``f``, captured: it
        reads the graphs' carry and writes its next carry back into it."""
        carry = self._adopt_carry()
        cfg = self.config
        center, scale_factor = self._constants

        def step():
            new, (output, _) = stabilize_step(carry, f, cfg, mode, center=center,
                                              scale_factor=scale_factor)
            _copy_carry(carry, new)
            return output

        step_counters["captures"] += 1
        return StepGraph(step, self.device)

    def _host_motion(self, f: torch.Tensor):
        """The host estimator stage: the track prefix on the device, one read
        of (previous corners | tracked points | status), the cv2exact RANSAC
        replica and de-scale in float64, the motion uploaded."""
        from video_stabilization_tpu_torch.motion.cv2_ransac import estimate_rigid_cv2_host

        pts, status = self._track(self.carry, f)
        with stage("host_read"):
            both = torch.cat([self.carry.corners_prev, pts, status.float()[:, None]], 1).cpu()
            self.host_reads += 1
        wh, ww = self.config.working_size
        with stage("host_ransac"):
            h, valid, n_inl = estimate_rigid_cv2_host(
                both[:, 0:2].numpy(), both[:, 2:4].numpy(), both[:, 4].numpy() > 0.5,
                center=(ww / 2.0, wh / 2.0), min_points=self.config.ransac.min_points,
                ransac_reproj_threshold=self.config.ransac.inlier_threshold)
        dev = self.device
        return (torch.tensor(h, dtype=torch.float32).to(dev, non_blocking=True),
                torch.tensor(valid).to(dev, non_blocking=True),
                torch.tensor(n_inl, dtype=torch.int32).to(dev, non_blocking=True))

    def _inject_host_corners(self, frame) -> None:
        """cv2's element-exact corner list of ``frame`` (``ops/gftt_host.py``)
        into the carry, so the next frame's hypothesis stream stays the
        reference pipeline's."""
        from video_stabilization_tpu_torch.ops.gftt_host import detect_corners_host

        if not isinstance(frame, np.ndarray):
            with stage("host_read"):
                frame = frame.cpu().numpy()
                self.host_reads += 1
        cfg = self.config
        wh, ww = cfg.working_size
        with stage("host_gftt"):
            pts, mask = detect_corners_host(
                np.asarray(frame, np.uint8), (wh, ww), cfg.gftt.max_features,
                cfg.gftt.quality_level, cfg.gftt.min_distance_at_720 * (wh / 720.0))
        dev = self.device
        self.carry = dataclasses.replace(
            self.carry, corners_prev=torch.from_numpy(pts).to(dev, non_blocking=True),
            corners_mask=torch.from_numpy(mask).to(dev, non_blocking=True))

    def stabilize_clip(self, frames) -> torch.Tensor:
        """Feed a (T, Hf, Wf, C) clip frame by frame; returns the outputs."""
        return torch.stack([self.stabilize_frame(f) for f in frames])

    @property
    def total_frame_window_size(self) -> int:
        return self.config.total_window
