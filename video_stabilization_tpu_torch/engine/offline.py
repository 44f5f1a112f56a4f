"""Offline chunked pipeline: K consecutive frames per call, the per-frame
stages batched over the chunk, and over S streams.

Port of ``video_stabilization_tpu/engine/offline.py`` (``offline_chunk_step``,
``_offline_config``, ``make_offline_fn``, ``make_offline_batched_fn``,
``stabilize_clip_offline``).  The expensive stages of frame i depend only on
frames i-1 and i, so a chunk runs them for all K frames at once; the JAX
package vmaps the chunk over streams, the port writes the stream dimension
out, so there is one chunk body, :func:`offline_batched_chunk_step`, over S
streams of K frames each (``offline_chunk_step`` is its S = 1 case):

  1. gray, pyramid and GFTT of the S·K frames as one batch;
  2. dense LK of the S·K pairs (each stream's carry pyramid and corners
     seed its pair 0) as one batch, then RANSAC and de-scale of the S·K
     pairs as one batch;
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

Semantics: K calls of :func:`~video_stabilization_tpu_torch.engine.stabilizer.stabilize_step`
per stream for any K up to the window W, with each stream's own ``fold_in``
frame keys (of its own frame counter), the first-frame quirk, lock
anchoring and sticky fallbacks.  Presentation frame j comes from the chunk
itself when it is one of the chunk's frames, else from the ring as it was
before the chunk's write.  (The JAX package reads all K from the ring after
the write, so there a frame written later in the chunk overwrites an
earlier presentation frame whenever K >= past_frames + 2; ROADMAP Queue 3.)

The warps take the JAX offline path's arguments: LK's and ECC's without the
projective fallback; the output warp without it in the bounded modes
(GLOBAL_SMOOTHING, TRANSLATION_LOCK) and with ``warp_projective_fallback``
in the others, which frame by frame is the JAX chunk-wide ``cond``
(``make_offline_batched_fn`` drops it in those too, as the JAX function
does).

The offline forms require ``config.static_mode``, as the JAX package's do;
K must not exceed W (the frame ring is written once per chunk).  The
batched step (K = 1, ``streaming``) also takes streams in mixed modes: with
no static mode it is given the S streams' host modes (``modes``, one read
of ``carry.mode`` per call by its caller) and runs the shared stages once
over all S streams; only the lock stage and the tail depend on the mode.
The accumulated lock runs over all S streams and is kept where a stream's
mode accumulates (a ``torch.where`` on a mask made on the device from
``carry.mode``), the registration lock runs for the ORB and SIFT streams
alone, each with its own detector, and the tail selects each stream's
stabilizing homography by its ``carry.mode`` before the one batched output
warp, which keeps ``warp_projective_fallback`` for every stream, as JAX
keeps it when no mode is pinned.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine.lock import _registration_lock, detect_features
from video_stabilization_tpu_torch.engine.smoothing import _prefix_products, smoothing_homography
from video_stabilization_tpu_torch.engine.stabilizer import (
    _fit_inter_frame,
    accumulating_modes,
    corner_config,
    frame_keys,
    next_corners,
    stabilized_outputs,
    working_gray,
)
from video_stabilization_tpu_torch.engine.state import EngineCarry, map_carry
from video_stabilization_tpu_torch.ops.gftt import good_features_to_track
from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_bilinear
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.ops.warp import _inv3x3
from video_stabilization_tpu_torch.utils.precision import in_float32
from video_stabilization_tpu_torch.utils.stage_profile import stage

# Modes whose output correction is bounded by construction, so the warp's
# ~9-degree rotation envelope always holds: smoothing corrects only residual
# shake around the window average, and translation lock cancels rotation
# before warping.  Their output warp never takes the projective fallback
# (JAX offline.py _BOUNDED_MODES, parallel/streams.py _BOUNDED_WARP_MODES).
# The accumulated / rotation / ORB / SIFT locks track an absolute pose
# offset that can grow without bound.
BOUNDED_MODES = (StabilizationMode.GLOBAL_SMOOTHING, StabilizationMode.TRANSLATION_LOCK)
REGISTRATION_MODES = (StabilizationMode.ORB_FULL_LOCK, StabilizationMode.SIFT_FULL_LOCK)


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
    streaming: bool = False,
    modes: Optional[Sequence[int]] = None,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process K consecutive frames of each of S streams, (S, K, Hf, Wf, C)
    uint8 on the carry's device, with a carry of S streams (every tensor
    (S, ...)) -> (carry', (outputs (S, K, Hf, Wf, C) u8, valid (S, K))),
    the same as K ``stabilize_step`` calls per stream.  ``carry.frames`` is
    updated in place.

    ``streaming`` gives the batched step (K = 1) the streaming step's
    stages where the JAX offline chunk differs from it: ECC with its warp
    fallback, cv2's exact u8 gray under ``reference_compat`` and empty
    corner lanes for ``gftt.selection="host"``.  Without it the chunk
    takes the JAX offline chunk's: the float gray, and the detector of
    ``corner_config`` (``"host"`` runs the cell selection).

    ``modes``: the S streams' modes as host ints (``carry.mode`` read by
    the caller), for the batched step in mixed modes: used only when
    ``config.static_mode`` is None and ``streaming`` is set; without a
    static mode and without them the call raises."""
    s_n, k = frames.shape[:2]
    if config.static_mode is not None:
        mode = StabilizationMode(int(config.static_mode))
        modes = [mode] * s_n
        fallback = config.warp_projective_fallback and mode not in BOUNDED_MODES
    elif modes is not None and streaming:
        mode = carry.mode[:, None]          # (S, 1): the tail's per-stream select
        modes = [StabilizationMode(int(m)) for m in modes]
        if len(modes) != s_n:
            raise ValueError(f"{len(modes)} modes for {s_n} streams")
        fallback = config.warp_projective_fallback
    else:
        require_static_mode(config, "offline pipeline")
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
    center = torch.tensor([ww / 2.0, wh / 2.0]).to(dev, non_blocking=True)
    scale_factor = torch.tensor(config.scale_factor).to(dev, non_blocking=True)
    eye = torch.eye(3, **f32)
    frames = frames.to(torch.uint8)
    flat = frames.reshape((s_n * k,) + frames.shape[2:])

    def per_stream(x):                  # (S·K, ...) -> (S, K, ...)
        return x.reshape((s_n, k) + x.shape[1:])

    def after_carry(prev, x):           # each stream's carry value, then its K-1 first
        return torch.cat([prev[:, None], per_stream(x)[:, :-1]], 1).reshape(x.shape)

    n0 = carry.n
    idxs = torch.arange(k, dtype=torch.int32, device=dev)
    ns = n0[:, None] + idxs                                      # (S, K)
    k_ransac, k_lock = frame_keys(carry.key[:, None, :], ns)     # (S, K, 2) each

    # 1. gray, pyramid and GFTT of the S·K frames (resize before gray)
    with stage("gray_pyramid"):
        if streaming:
            grays = working_gray(flat, config)
        else:
            grays = bgr_to_gray(resize_bilinear(flat.float(), wh, ww))
        pyrs = build_pyramid(grays, config.lk.pyramid_levels)
    with stage("gftt"):
        if streaming:
            corners = next_corners(grays, config)
        else:
            corners = good_features_to_track(grays, corner_config(config))

    # 2. LK and RANSAC of the S·K pairs, each as one batch
    pts_prev = after_carry(carry.corners_prev, corners.points)
    with stage("lk"):
        tracked = lk_track([after_carry(a, b) for a, b in zip(carry.pyr_prev, pyrs)], pyrs,
                           pts_prev, after_carry(carry.corners_mask, corners.mask), config.lk)
    with stage("fit"):
        ransac, t_rigid = _fit_inter_frame(pts_prev, tracked.points, tracked.status,
                                           k_ransac.reshape(-1, 2), config, center)
    have_prev = ns >= 1
    t_new = torch.where((have_prev & per_stream(ransac.valid))[..., None, None],
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
                                                 ecc_warp_fallback=streaming)
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
        fallback, config.ransac.motion_model == "homography")
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
        last_inliers=per_stream(ransac.num_inliers)[:, -1],
        last_lock_matches=lock_matches[:, -1],
        envelope_violations=carry.envelope_violations + outside.sum(-1).to(torch.int32),
        key=carry.key,
    )
    return new_carry, (outputs, out_valid)


def offline_chunk_step(
    carry: EngineCarry,
    frames: torch.Tensor,
    config: StabilizerConfig,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process K consecutive (K, Hf, Wf, C) uint8 frames on the carry's
    device -> (carry', (outputs (K, Hf, Wf, C) u8, valid (K,))), the same as
    K ``stabilize_step`` calls: :func:`offline_batched_chunk_step` on one
    stream.  ``carry.frames`` is updated in place."""
    require_static_mode(config, "offline pipeline")
    carry, (outputs, valid) = offline_batched_chunk_step(
        map_carry(lambda x: x[None], carry), frames[None], config)
    return map_carry(lambda x: x[0], carry), (outputs[0], valid[0])


def _offline_config(config: StabilizerConfig) -> StabilizerConfig:
    """LK's warps without the projective fallback, as the JAX offline path
    runs them: they remove the current global-motion estimate first, so
    their transforms are small by construction."""
    return dataclasses.replace(config, lk=dataclasses.replace(config.lk, warp_fallback=False))


@functools.lru_cache(maxsize=32)
def make_offline_fn(config: StabilizerConfig) -> Callable:
    """(carry, frames (K, Hf, Wf, C)) -> (carry, (outputs, valid)) for any
    K up to the window, in float32 whatever the caller set for TF32; one
    callable per config."""
    return in_float32(functools.partial(offline_chunk_step, config=_offline_config(config)))


@functools.lru_cache(maxsize=32)
def make_offline_batched_fn(config: StabilizerConfig) -> Callable:
    """(carry of S streams, frames (S, K, Hf, Wf, C)) -> (carry, (outputs
    (S, K, Hf, Wf, C), valid (S, K))): the chunk over streams, with the JAX
    function's warp arguments (``offline.py::make_offline_batched_fn``): LK
    and ECC without the projective fallback, and the output warp without it
    in every mode (the bounded modes never take it, the others drop it
    here).  Requires ``config.static_mode``.  Float32 whatever the caller
    set for TF32 (``utils/precision.py``)."""
    require_static_mode(config, "make_offline_batched_fn")
    cfg = _offline_config(config)
    if int(cfg.static_mode) not in BOUNDED_MODES:
        cfg = dataclasses.replace(cfg, warp_projective_fallback=False)
    return in_float32(functools.partial(offline_batched_chunk_step, config=cfg))


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
