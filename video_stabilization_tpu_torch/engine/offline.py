"""The engine's one step body, over S streams of K frames, and its forms.

Port of ``video_stabilization_tpu/engine/offline.py`` (``offline_chunk_step``,
``_offline_config``, ``make_offline_fn``, ``make_offline_batched_fn``,
``stabilize_clip_offline``) and of the stages of the JAX package's streaming
step.  The JAX package writes the streaming step and the chunk apart and
vmaps them over streams; the port writes the stream dimension out and keeps
one sequence of stages, :func:`offline_batched_chunk_step`, over S streams
of K frames each.  Every form is a call of it:

  - the streaming step (``engine/stabilizer.py::stabilize_step``, which
    ``Stabilizer`` replays as a CUDA graph): one stream, one frame;
  - the batched step, its scan and the sharded step
    (``parallel/streams.py``): S streams, one frame;
  - the offline chunk (:func:`offline_chunk_step`, :func:`make_offline_fn`):
    one stream, K frames;
  - the stream-batched chunk and its sharded form
    (:func:`make_offline_batched_fn`, which replays a CUDA graph of it per
    slot on a card): S streams, K frames.

The expensive stages of frame i depend only on frames i-1 and i, so the
body runs them for all S·K frames at once:

  1. gray, pyramid and GFTT of the S·K frames as one batch;
  2. dense LK of the S·K pairs (each stream's carry pyramid and corners
     seed its pair 0) as one batch, then RANSAC and de-scale of the S·K
     pairs as one batch; or the motion a host estimator computed
     (``ext_motion``, the referee's);
  3. the short sequential chains as tensor ops over K: the K smoothing
     windows, the accumulated lock's masked prefix product (newest factor
     on the left) and the registration lock's sticky fallback;
  4. the S·K output warps as one batched warp (one batched
     ``warp_perspective`` for the homography model).

So with dense LK the warp kernel launches four times for LK and once for
the output per call (four in all with the homography model), whatever S
and K.  The registration lock (detection, matching, RANSAC, ECC) stays per
frame, in a Python loop over the streams and then the chunk that reads
nothing back.

Semantics: K streaming steps per stream for any K up to the window W, with
each stream's own ``fold_in`` frame keys (of its own frame counter), the
first-frame quirk, lock anchoring and sticky fallbacks.  Presentation frame
j comes from the chunk itself when it is one of the chunk's frames, else
from the ring as it was before the chunk's write.  (The JAX package reads
all K from the ring after the write, so there a frame written later in the
chunk overwrites an earlier presentation frame whenever K >= past_frames +
2; ROADMAP Queue 3.)

The forms differ only in what :data:`FORMS` holds, one row each: the
streaming step's stages or the JAX offline chunk's, and the arguments of
the three kinds of warp (LK's, the output warp's, ECC's).

The offline forms require ``config.static_mode``, as the JAX package's do;
K must not exceed W (the frame ring is written once per chunk).  The
streaming forms take the streams' host modes instead (``modes``: the
streaming step's one mode, or the batched step's read of ``carry.mode``)
and run the shared stages once over all S streams; only the lock stage and
the tail depend on the mode.  In a batch of mixed modes the accumulated
lock runs over all S streams and is kept where a stream's mode accumulates
(a ``torch.where`` on a mask made on the device from ``carry.mode``), the
registration lock runs for the ORB and SIFT streams alone, each with its
own detector, and the tail selects each stream's stabilizing homography by
its ``carry.mode`` before the one batched output warp.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine.lock import _registration_lock, detect_features
from video_stabilization_tpu_torch.engine.smoothing import _prefix_products, smoothing_homography
from video_stabilization_tpu_torch.engine.state import EngineCarry, map_carry
from video_stabilization_tpu_torch.engine.step_graph import (
    GraphCache, StepGraph, copy_carry, static_input)
from video_stabilization_tpu_torch.models.motion_models import MotionModel, fit_motion
from video_stabilization_tpu_torch.motion.homography import (
    HomographyParams,
    compose_homography,
    decompose_homography,
    remove_isotropic_scale,
)
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops.affine_warp import affine_envelope_ok, warp_affine
from video_stabilization_tpu_torch.ops.gftt import Corners, good_features_to_track
from video_stabilization_tpu_torch.ops.image import (
    bgr_to_gray, gray_u8_cv2exact, resize_bilinear)
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.ops.warp import _inv3x3, warp_perspective
from video_stabilization_tpu_torch.utils import prng
from video_stabilization_tpu_torch.utils.precision import in_float32
from video_stabilization_tpu_torch.utils.stage_profile import stage

ACCUM_MODES = (
    StabilizationMode.ACCUMULATED_FULL_LOCK,
    StabilizationMode.TRANSLATION_LOCK,
    StabilizationMode.ROTATION_LOCK,
)
# Modes whose output correction is bounded by construction, so the warp's
# ~9-degree rotation envelope always holds: smoothing corrects only residual
# shake around the window average, and translation lock cancels rotation
# before warping.  The accumulated / rotation / ORB / SIFT locks track an
# absolute pose offset that can grow without bound.
BOUNDED_MODES = (StabilizationMode.GLOBAL_SMOOTHING, StabilizationMode.TRANSLATION_LOCK)
REGISTRATION_MODES = (StabilizationMode.ORB_FULL_LOCK, StabilizationMode.SIFT_FULL_LOCK)


class Form(NamedTuple):
    """One row of :data:`FORMS`."""

    streaming: bool         # the streaming step's stages, else the JAX offline chunk's
    lk_fallback: bool       # LK's warps keep ``config.lk.warp_fallback``, else without it
    output_modes: tuple     # the modes whose output warp keeps ``warp_projective_fallback``
    ecc_fallback: bool      # ECC's ``warp_fallback``


ALL_MODES = tuple(StabilizationMode)
UNBOUNDED_MODES = tuple(m for m in StabilizationMode if m not in BOUNDED_MODES)

# Each form takes the arguments of the JAX function it ports, quirks
# included (ROADMAP Queue 1, "Faults of the reference"): the JAX batched
# step keeps the output warp's projective fallback in the unbounded modes
# (every mode when none is pinned) where the stream-batched chunk drops it in
# every mode; LK's warps, which remove the current global-motion estimate
# first, run without it in the batched and offline forms; ECC keeps it only
# where the streaming step's stages run.  The streaming stages: cv2's exact
# u8 gray under ``reference_compat``, empty corner lanes for
# ``gftt.selection="host"`` (:func:`next_corners`) and host ``modes``; the
# chunk's: the float gray and :func:`corner_config`'s detector ("host" runs
# the cell selection).
FORMS = {
    "step": Form(True, True, ALL_MODES, True),                    # stabilize_step
    "batched": Form(True, False, UNBOUNDED_MODES, True),          # make_batched_step_fn, pinned
    "batched_mixed": Form(True, False, ALL_MODES, True),          # ... no static mode
    "offline": Form(False, False, UNBOUNDED_MODES, False),        # make_offline_fn
    "offline_batched": Form(False, False, (), False),             # make_offline_batched_fn
    "chunk": Form(False, True, UNBOUNDED_MODES, False),           # the body called directly
}


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


def step_replays(config: StabilizerConfig, device) -> bool:
    """Whether a form of ``config`` on ``device`` replays as a CUDA graph
    (``Stabilizer``'s step, the stream-batched chunk), in a mode other than
    the registration locks: on a CUDA card, unless a stage reads the device
    to the host, which capture refuses: the referee's host estimator
    (``ransac.method="cv2exact"``), host GFTT and cv2's exact greedy corners
    (``gftt.selection`` "host" or "cv2exact", or ``reference_compat``)."""
    return (torch.device(device).type == "cuda" and config.ransac.method != "cv2exact"
            and corner_config(config).selection not in ("host", "cv2exact"))


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
    """The body's tail over any leading dims ((S, K) in the body): rotation
    split of ``h_lock``, the mode's stabilizing homography, its rescale to
    full resolution, and one batched warp of all (..., Hf, Wf, C)
    presentation frames, each with the border 0.5 · its mean colour; where
    ``is_first``, the new frame in ``frames`` passes through unwarped.  With
    ``homography`` (the homography motion model) the projective row rescales
    too and the frames go through ``warp_perspective``, which has no
    envelope.  ``mode`` is a host int, or an int32 tensor that broadcasts
    against the leading dims (the (S, 1) modes of a batch of streams in
    mixed modes, on the device): each item then takes its own mode's
    homography by ``torch.where``.  Returns (h_stab (..., 3, 3), outputs
    (..., Hf, Wf, C) u8, (...) bool: ``h_stab`` outside the warp kernel's
    envelope)."""
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


def require_static_mode(config: StabilizerConfig, what: str) -> StabilizationMode:
    """The pinned mode of the offline chunk and serving forms; raises
    without one, as the JAX package's offline forms and serving do.  (The
    batched step, its scan and the sharded step take streams in mixed
    modes instead: :func:`offline_batched_chunk_step`'s ``modes``.)"""
    if config.static_mode is None:
        raise ValueError(
            f"{what} requires config.static_mode (the offline chunk and serving run one "
            "mode for every stream, as in the JAX package); use "
            "dataclasses.replace(config, static_mode=int(mode))")
    return StabilizationMode(int(config.static_mode))


def _mode_in(mode: torch.Tensor, modes) -> torch.Tensor:
    """(S,) bool on ``mode``'s device: each stream's ``carry.mode`` is one
    of ``modes`` (no host read)."""
    hit = torch.zeros(mode.shape, dtype=torch.bool, device=mode.device)
    for m in modes:
        hit = hit | (mode == int(m))
    return hit


def _presentation_frames(ring: torch.Tensor, frames: torch.Tensor, pres_abs: torch.Tensor,
                         n0: torch.Tensor) -> torch.Tensor:
    """(S, K, Hf, Wf, C) u8 presentation frames: frame ``pres_abs[s, j]`` of
    stream s from the chunk ``frames`` (absolute indices ``n0[s] ..``) when
    it is there, else from ``ring`` (S, W, ...) before this chunk's write
    (``pres_abs[s, j] > n0[s] - W``, so its slot still holds it).  Flat
    indices ``s·K + j`` and ``s·W + slot`` address the streams' frames."""
    s_n, k = frames.shape[:2]
    w = ring.shape[1]
    streams = torch.arange(s_n, device=ring.device)[:, None]
    rel = pres_abs - n0[:, None]
    from_chunk = frames.reshape((s_n * k,) + frames.shape[2:]).index_select(
        0, (streams * k + rel.clamp(0, k - 1)).reshape(-1).long())
    from_ring = ring.reshape((s_n * w,) + ring.shape[2:]).index_select(
        0, (streams * w + torch.remainder(pres_abs, w)).reshape(-1).long())
    picked = torch.where((rel >= 0).reshape(-1)[:, None, None, None], from_chunk, from_ring)
    return picked.reshape(frames.shape)


def offline_batched_chunk_step(
    carry: EngineCarry,
    frames: torch.Tensor,
    config: StabilizerConfig,
    *,
    form: str = "chunk",
    modes: Optional[Sequence[int]] = None,
    ext_motion=None,
    center: torch.Tensor | None = None,
    scale_factor: torch.Tensor | None = None,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process K consecutive frames of each of S streams, (S, K, Hf, Wf, C)
    uint8 on the carry's device, with a carry of S streams (every tensor
    (S, ...)) -> (carry', (outputs (S, K, Hf, Wf, C) u8, valid (S, K))),
    the same as K streaming steps per stream.  ``carry.frames`` is updated
    in place.

    ``form``: the row of :data:`FORMS` the call runs; by default the chunk
    body's own.

    ``modes``: the S streams' modes as host ints, for the streaming forms
    without ``config.static_mode`` (which overrides them); the offline
    forms and the streaming forms without either raise.

    ``ext_motion``: an optional ``(h (S, K, 3, 3) f32, valid (S, K) bool,
    n_inliers (S, K) int32)`` inter-frame rigid motion computed by a host
    estimator (the cv2exact RANSAC replica, ``motion/cv2_ransac.py``);
    given, the call skips its own LK and RANSAC stages.

    ``center`` and ``scale_factor``: the working image's (2,) f32 centre and
    the () f32 working-to-full scale on the carry's device, as
    :func:`step_constants` makes them; without them the call uploads both
    from the host, which a CUDA graph's capture refuses."""
    row = FORMS[form]
    s_n, k = frames.shape[:2]
    if config.static_mode is not None:
        modes = [config.static_mode] * s_n
    elif modes is None or not row.streaming:
        require_static_mode(config, "offline pipeline")
    modes = [StabilizationMode(int(m)) for m in modes]
    if len(modes) != s_n:
        raise ValueError(f"{len(modes)} modes for {s_n} streams")
    # the tail's mode: one host int, or in a batch of mixed modes each
    # stream's (S, 1) on the device
    mode = modes[0] if len(set(modes)) == 1 else carry.mode[:, None]
    w = config.total_window
    if k > w:
        raise ValueError(f"chunk size {k} exceeds temporal window {w}")

    dev = carry.frames.device
    if frames.device != dev:
        raise ValueError(f"frames on {frames.device}, carry on {dev}: the offline step runs "
                         "on the carry's device; move the frames there")
    if carry.frames.shape[0] != s_n:
        raise ValueError(f"frames of {s_n} streams for a carry of {carry.frames.shape[0]}")
    f32 = dict(dtype=torch.float32, device=dev)
    future = config.future_frames
    wh, ww = config.working_size
    if center is None or scale_factor is None:
        center, scale_factor = step_constants(config, dev)
    eye = torch.eye(3, **f32)
    frames = frames.to(torch.uint8)
    flat = frames.reshape((s_n * k,) + frames.shape[2:])

    def per_stream(x):                  # (S·K, ...) -> (S, K, ...)
        return x.reshape((s_n, k) + x.shape[1:])

    def after_carry(prev, x):           # each stream's carry value, then its K-1 first
        if k == 1:
            return prev
        return torch.cat([prev[:, None], per_stream(x)[:, :-1]], 1).reshape(x.shape)

    n0 = carry.n
    idxs = torch.arange(k, dtype=torch.int32, device=dev)
    ns = n0[:, None] + idxs                                      # (S, K)
    k_ransac, k_lock = frame_keys(carry.key[:, None, :], ns)     # (S, K, 2) each

    # 1. gray, pyramid and GFTT of the S·K frames (resize before gray)
    with stage("gray_pyramid"):
        if row.streaming:
            grays = working_gray(flat, config)
        else:
            grays = bgr_to_gray(resize_bilinear(flat.float(), wh, ww))
        pyrs = build_pyramid(grays, config.lk.pyramid_levels)
    with stage("gftt"):
        if row.streaming:
            corners = next_corners(grays, config)
        else:
            corners = good_features_to_track(grays, corner_config(config))

    # 2. LK and RANSAC of the S·K pairs, each as one batch, unless a host
    # estimator gave the motion
    if ext_motion is None:
        lk = config.lk if row.lk_fallback else dataclasses.replace(config.lk, warp_fallback=False)
        pts_prev = after_carry(carry.corners_prev, corners.points)
        with stage("lk"):
            tracked = lk_track([after_carry(a, b) for a, b in zip(carry.pyr_prev, pyrs)], pyrs,
                               pts_prev, after_carry(carry.corners_mask, corners.mask), lk)
        with stage("fit"):
            ransac, t_rigid = _fit_inter_frame(pts_prev, tracked.points, tracked.status,
                                               k_ransac.reshape(-1, 2), config, center)
        fit_valid, n_inliers = ransac.valid, ransac.num_inliers
    else:
        t_rigid, fit_valid, n_inliers = (x.flatten(0, 1) for x in ext_motion)
    have_prev = ns >= 1
    t_new = torch.where((have_prev & per_stream(fit_valid))[..., None, None],
                        per_stream(t_rigid), eye)

    # 3. the window after step j is ext[:, j+1 : j+w]; ext[:, i] holds the
    # transform into frame i - (w-1) + n0.  The very first frame does not
    # push in the streaming step, but its slot here is identity and invalid,
    # which every consumer reads the same way.
    ext = torch.cat([carry.transforms, t_new], 1)
    ext_v = torch.cat([carry.tvalid, have_prev], 1)
    n_after = ns + 1
    length = n_after.clamp(max=w)
    num_tr = length - 1
    zero_i = torch.zeros_like(length)
    pres = torch.where(length > future, length - future - 1, zero_i)
    pres_abs = torch.where(n_after > future, n_after - future - 1, zero_i)
    with stage("smoothing"):
        win = (torch.arange(k, device=dev)[:, None] + 1
               + torch.arange(w - 1, device=dev)[None, :])
        h_smooth = smoothing_homography(ext[:, win], ext_v[:, win], pres, num_tr,
                                        config.reference_compat)

    # 4. presentation frames, then the ring write (stream s, slot i at s·W + i)
    pres_frames = _presentation_frames(carry.frames, frames, pres_abs, n0)
    streams = torch.arange(s_n, device=dev)[:, None]
    ring = carry.frames.view((s_n * w,) + carry.frames.shape[2:])
    ring.index_copy_(0, (streams * w + torch.remainder(ns, w)).reshape(-1).long(), flat)

    # 5. lock transforms: the accumulated lock over every stream, kept
    # where the stream's mode accumulates; the registration lock for the
    # ORB and SIFT streams alone; the lock cleared elsewhere
    orb_ref, sift_ref, lock_prev_h = carry.orb_ref, carry.sift_ref, carry.lock_prev_h
    lock_matches = torch.zeros((s_n, k), dtype=torch.int32, device=dev)
    h_lock = eye.expand(s_n, k, 3, 3)
    accum_h = eye.expand(s_n, 3, 3).clone()
    accum_active = torch.zeros(s_n, dtype=torch.bool, device=dev)
    accumulating = [m in accumulating_modes(config) for m in modes]
    if any(accumulating):
        with stage("lock"):
            h0 = torch.where(carry.accum_active[:, None, None], carry.accum_h, eye)
            advanced = (n_after - 1 - future) >= 1
            # the anchor step itself never advances
            adv = advanced & (carry.accum_active[:, None] | (idxs >= 1))
            t_pres = ext[streams, (pres_abs - n0[:, None] + (w - 1)).clamp(0, w - 2 + k).long()]
            m_seq = torch.where(adv[..., None, None], t_pres, eye)
            accum_seq = torch.matmul(_prefix_products(m_seq, left=True), h0[:, None])
            h_lock = _inv3x3(accum_seq)
            accum_h = accum_seq[:, -1]
            accum_active = torch.ones(s_n, dtype=torch.bool, device=dev)
            if not all(accumulating):
                accum_active = _mode_in(carry.mode, accumulating_modes(config))
                h_lock = torch.where(accum_active[:, None, None, None], h_lock, eye)
                accum_h = torch.where(accum_active[:, None, None], accum_h, eye)
    registering = [s for s, m in enumerate(modes) if m in REGISTRATION_MODES]
    if registering:
        with stage("lock"):
            with stage("lock_detect"):
                found = {(s, j): detect_features(pres_frames[s, j].float(), config,
                                                 modes[s] == StabilizationMode.ORB_FULL_LOCK)
                         for s in registering for j in range(k)}
            # each stream's reference is captured on its first frame if
            # unset; the sticky fallback runs frame to frame
            with stage("lock_register"):
                hs, matches, new_refs, new_prev = {}, {}, {}, {}
                for s in registering:
                    use_orb = modes[s] == StabilizationMode.ORB_FULL_LOCK
                    ref = map_carry(lambda x: x[s], orb_ref if use_orb else sift_ref)
                    prev_h = lock_prev_h[s]
                    h_s, m_s = [], []
                    for j in range(k):
                        feats, proc, c = found[s, j]
                        res = _registration_lock(feats.points, feats.desc, feats.mask, proc,
                                                 ref, prev_h, k_lock[s, j], config, c, use_orb,
                                                 ecc_warp_fallback=row.ecc_fallback)
                        ref, prev_h = res.ref, res.prev_h
                        h_s.append(res.h_lock)
                        m_s.append(res.n_matches)
                    hs[s], matches[s] = torch.stack(h_s), torch.stack(m_s)
                    new_refs[s], new_prev[s] = ref, prev_h
        h_lock = torch.stack([hs[s] if s in hs else h_lock[s] for s in range(s_n)])
        lock_matches = torch.stack([matches[s] if s in matches else lock_matches[s]
                                    for s in range(s_n)])
        lock_prev_h = torch.stack([new_prev[s] if s in new_prev else lock_prev_h[s]
                                   for s in range(s_n)])

        def refs_of(ref, lock_mode):    # the new reference of each stream in lock_mode
            mine = [s for s in registering if modes[s] == lock_mode]
            if not mine:
                return ref
            return map_carry(lambda *xs: torch.stack(xs), *[
                new_refs[s] if s in mine else map_carry(lambda x: x[s], ref)
                for s in range(s_n)])

        orb_ref = refs_of(orb_ref, StabilizationMode.ORB_FULL_LOCK)
        sift_ref = refs_of(sift_ref, StabilizationMode.SIFT_FULL_LOCK)

    # 6. rotation split, mode select, rescale and one batched warp
    h_stab, outputs, outside = stabilized_outputs(
        mode, h_smooth, h_lock, pres_frames, frames, ns == 0, center, scale_factor,
        config.warp_projective_fallback and all(m in row.output_modes for m in modes),
        config.ransac.motion_model == "homography")
    out_valid = torch.ones((s_n, k), dtype=torch.bool, device=dev)

    new_carry = EngineCarry(
        frames=carry.frames,
        transforms=ext[:, k:],
        tvalid=ext_v[:, k:],
        pyr_prev=tuple(per_stream(p)[:, -1] for p in pyrs),
        corners_prev=per_stream(corners.points)[:, -1],
        corners_mask=per_stream(corners.mask)[:, -1],
        n=n0 + k,
        mode=carry.mode,
        accum_h=accum_h,
        accum_active=accum_active,
        orb_ref=orb_ref,
        sift_ref=sift_ref,
        lock_prev_h=lock_prev_h,
        last_h=h_stab[:, -1],
        last_inliers=per_stream(n_inliers)[:, -1],
        last_lock_matches=lock_matches[:, -1],
        envelope_violations=carry.envelope_violations + outside.sum(-1).to(torch.int32),
        key=carry.key,
    )
    return new_carry, (outputs, out_valid)


def one_stream(carry: EngineCarry, frames: torch.Tensor, config: StabilizerConfig, form: str,
               **kw) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """The body in ``form`` on one stream: a carry without the stream axis
    and (K, Hf, Wf, C) frames -> (carry', (outputs (K, Hf, Wf, C), valid
    (K,))).  A tensor the body passes through (the frame ring, updated in
    place; the key; a lock state the mode leaves alone) comes back as the
    caller's own."""
    batched = map_carry(lambda x: x[None], carry)
    new, (outputs, valid) = offline_batched_chunk_step(batched, frames[None], config,
                                                       form=form, **kw)
    return (map_carry(lambda x, b, y: x if y is b else y[0], carry, batched, new),
            (outputs[0], valid[0]))


def offline_chunk_step(
    carry: EngineCarry,
    frames: torch.Tensor,
    config: StabilizerConfig,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process K consecutive (K, Hf, Wf, C) uint8 frames on the carry's
    device -> (carry', (outputs (K, Hf, Wf, C) u8, valid (K,))), the same as
    K ``stabilize_step`` calls: :func:`offline_batched_chunk_step` on one
    stream.  ``carry.frames`` is updated in place."""
    return one_stream(carry, frames, config, "chunk")


@functools.lru_cache(maxsize=32)
def make_offline_fn(config: StabilizerConfig) -> Callable:
    """(carry, frames (K, Hf, Wf, C)) -> (carry, (outputs, valid)) for any
    K up to the window, in float32 whatever the caller set for TF32; one
    callable per config."""
    return in_float32(functools.partial(one_stream, config=config, form="offline"))


# what the callables of make_offline_batched_fn did since the last
# reset_chunk_counters(): their calls, the calls that replayed a CUDA graph
# of the chunk, and the graphs they captured; host counts, read without a sync
chunk_counters: dict = {}


def reset_chunk_counters() -> None:
    chunk_counters.clear()
    chunk_counters.update(calls=0, replays=0, captures=0)


reset_chunk_counters()


class _RingGraphs:
    """The chunk's CUDA graphs of one frame ring, by frames shape and dtype
    (``engine/step_graph.py``): the carry they read and write, which holds
    every tensor of the slot's carry but the ring (a placeholder stands in
    for it, so the ring dies with the caller's last carry), and their
    static frames."""

    def __init__(self, body: Callable, config: StabilizerConfig, device):
        self.body, self.device = body, device
        self.graphs = GraphCache()
        self.carry: Optional[EngineCarry] = None
        self.inputs: dict = {}
        self.constants = step_constants(config, device)

    def __call__(self, carry: EngineCarry, frames: torch.Tensor):
        ring = carry.frames
        f = static_input(self.inputs, frames, self.device)
        key = (tuple(frames.shape), frames.dtype)
        graph = self.graphs.get(key, lambda: self._capture(carry, ring, f))
        if graph is None:
            return self.body(carry, frames)
        with stage("chunk_replay"):
            self._adopt(carry, ring)
            outputs, valid = graph.replay()
            result = (dataclasses.replace(self.carry, frames=ring),
                      (outputs.clone(), valid.clone()))
        chunk_counters["replays"] += 1
        return result

    def _adopt(self, carry: EngineCarry, ring: torch.Tensor) -> EngineCarry:
        """The graphs' carry with ``ring``: at first a copy of ``carry``,
        later the same tensors refilled from ``carry`` where it is not
        theirs (an eager call's, or a carry put in the slot's place)."""
        if self.carry is None:
            self.carry = map_carry(torch.clone, dataclasses.replace(carry, frames=ring[:0]))
        mine = dataclasses.replace(self.carry, frames=ring)
        copy_carry(mine, carry)
        return mine

    def _capture(self, carry: EngineCarry, ring: torch.Tensor, f: torch.Tensor) -> StepGraph:
        """The chunk on the static frames ``f``, captured: it reads the
        graphs' carry and writes its next carry back into it."""
        mine = self._adopt(carry, ring)
        center, scale_factor = self.constants

        def chunk():
            new, (outputs, valid) = self.body(mine, f, center=center,
                                              scale_factor=scale_factor)
            copy_carry(mine, new)
            return outputs, valid

        chunk_counters["captures"] += 1
        return StepGraph(chunk, self.device)


class _ChunkReplay:
    """The callable of :func:`make_offline_batched_fn`."""

    def __init__(self, config: StabilizerConfig):
        self.config = config
        self.body = in_float32(functools.partial(offline_batched_chunk_step, config=config,
                                                 form="offline_batched"))
        self.pinned = StabilizationMode(int(config.static_mode))
        self._rings: dict = {}      # id(ring) -> _RingGraphs, dropped with the ring

    def __call__(self, carry: EngineCarry, frames: torch.Tensor, modes=None):
        chunk_counters["calls"] += 1
        ring = carry.frames
        if (self.pinned in REGISTRATION_MODES or frames.device != ring.device
                or not step_replays(self.config, ring.device)):
            return self.body(carry, frames, modes=modes)
        graphs = self._rings.get(id(ring))
        if graphs is None:
            graphs = self._rings[id(ring)] = _RingGraphs(self.body, self.config, ring.device)
            weakref.finalize(ring, self._rings.pop, id(ring), None)
        return graphs(carry, frames)


@functools.lru_cache(maxsize=32)
def make_offline_batched_fn(config: StabilizerConfig) -> Callable:
    """(carry of S streams, frames (S, K, Hf, Wf, C)) -> (carry, (outputs
    (S, K, Hf, Wf, C), valid (S, K))): the chunk over streams.  Requires
    ``config.static_mode``.  Float32 whatever the caller set for TF32
    (``utils/precision.py``).

    Where :func:`step_replays` holds, outside the registration locks, the
    chunk replays a CUDA graph of the body (``engine/step_graph.py``), one
    per frame ring and frames shape and dtype: a carry's ring is its slot's
    (the body writes it in place, every carry of the slot shares it), so
    each slot of a mesh, and each stream group on one card, has graphs of
    its own, and they go when the ring goes.  A key's first call runs
    eagerly, its second captures; each replay copies ``frames`` into the
    graph's input, runs under ``chunk_replay`` and returns fresh outputs
    and ``valid``.  The carry it returns is the graph's own, its tensors
    overwritten by the next replay of the slot, so a carry read before a
    call is no snapshot of it after the call (its ring never was); a carry
    that is not the graph's, but shares its ring (an eager call's, or one
    put in its place), is copied in first.  :data:`chunk_counters` counts
    the calls, replays and captures.  ``body`` is the chunk run eagerly,
    for stage profiles (no stage range opens inside a replay)."""
    require_static_mode(config, "make_offline_batched_fn")
    return _ChunkReplay(config)


def stabilize_clip_offline(
    carry: EngineCarry,
    frames,
    config: StabilizerConfig,
    chunk: int = 16,
) -> Tuple[EngineCarry, torch.Tensor]:
    """Run a (T, Hf, Wf, C) uint8 clip (array or tensor) through the offline
    pipeline in ``chunk``-frame calls, the last one partial, on the carry's
    device.  Returns (carry, outputs (T, Hf, Wf, C))."""
    step = make_offline_fn(config)
    dev = carry.frames.device
    outs = []
    for i in range(0, len(frames), chunk):
        part = frames[i:i + chunk]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.require(part, requirements=("C", "W")))
        carry, (out, _) = step(carry, part.to(dev))
        outs.append(out)
    return carry, torch.cat(outs)
