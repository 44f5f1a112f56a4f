"""Offline chunked pipeline: K consecutive frames per call, the per-frame
stages batched over the chunk.

Port of ``video_stabilization_tpu/engine/offline.py`` (``offline_chunk_step``,
``_offline_config``, ``make_offline_fn``, ``stabilize_clip_offline``).  The
expensive stages of frame i depend only on frames i-1 and i, so a chunk runs
them for all K frames at once:

  1. gray, pyramid and GFTT of the K frames as one batch;
  2. dense LK of the K pairs (the carry's pyramid and corners seed pair 0),
     then RANSAC and de-scale of the K pairs as one batch;
  3. the short sequential chains as tensor ops over K: the K smoothing
     windows, the accumulated lock's masked prefix product (newest factor
     on the left) and the registration lock's sticky fallback;
  4. the K output warps.

Dense LK, the registration lock (detection, matching, RANSAC, ECC) and the
output warp stay per frame, in a Python loop over the chunk that reads
nothing back: the warp kernel and those per-image ops have no batch
dimension yet (ROADMAP Queue 2, K4).

Semantics: K calls of :func:`~video_stabilization_tpu_torch.engine.stabilizer.stabilize_step`
for any K up to the window W, with the same ``fold_in`` frame keys, the
first-frame quirk, lock anchoring and sticky fallbacks.  Presentation frame j
comes from the chunk itself when it is one of the chunk's frames, else from
the ring as it was before the chunk's write.  (The JAX package reads all K
from the ring after the write, so there a frame written later in the chunk
overwrites an earlier presentation frame whenever K >= past_frames + 2;
ROADMAP Queue 3.)

The warps take the JAX offline path's arguments: LK's and ECC's without the
projective fallback; the output warp without it in the bounded modes
(GLOBAL_SMOOTHING, TRANSLATION_LOCK) and with ``warp_projective_fallback``
in the others, which frame by frame is the JAX chunk-wide ``cond``.

``config.static_mode`` is required, and K must not exceed W (the frame ring
is written once per chunk).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine.lock import _registration_lock, detect_features
from video_stabilization_tpu_torch.engine.smoothing import _prefix_products, smoothing_homography
from video_stabilization_tpu_torch.engine.stabilizer import (
    ACCUM_MODES,
    _fit_inter_frame,
    check_config,
    frame_keys,
    stabilized_outputs,
)
from video_stabilization_tpu_torch.engine.state import EngineCarry
from video_stabilization_tpu_torch.ops.gftt import good_features_to_track
from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_bilinear
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.ops.warp import _inv3x3
from video_stabilization_tpu_torch.utils.stage_profile import stage

# modes whose output correction is bounded by construction: their output
# warp never takes the projective fallback (JAX offline.py _BOUNDED_MODES)
BOUNDED_MODES = (StabilizationMode.GLOBAL_SMOOTHING, StabilizationMode.TRANSLATION_LOCK)
REGISTRATION_MODES = (StabilizationMode.ORB_FULL_LOCK, StabilizationMode.SIFT_FULL_LOCK)


def _presentation_frames(ring: torch.Tensor, frames: torch.Tensor, pres_abs: torch.Tensor,
                         n0: torch.Tensor) -> torch.Tensor:
    """(K, Hf, Wf, C) u8 presentation frames: frame ``pres_abs[j]`` from the
    chunk ``frames`` (absolute indices ``n0 ..``) when it is there, else
    from ``ring`` before this chunk's write (``pres_abs[j] > n0 - W``, so its
    slot still holds it)."""
    rel = pres_abs - n0
    from_chunk = frames.index_select(0, rel.clamp(0, frames.shape[0] - 1).long())
    from_ring = ring.index_select(0, torch.remainder(pres_abs, ring.shape[0]).long())
    return torch.where((rel >= 0)[:, None, None, None], from_chunk, from_ring)


def offline_chunk_step(
    carry: EngineCarry,
    frames: torch.Tensor,
    config: StabilizerConfig,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process K consecutive (K, Hf, Wf, C) uint8 frames on the carry's
    device -> (carry', (outputs (K, Hf, Wf, C) u8, valid (K,))), the same as
    K ``stabilize_step`` calls.  ``carry.frames`` is updated in place."""
    if config.static_mode is None:
        raise ValueError(
            "offline pipeline requires config.static_mode (one pipeline per "
            "mode); use dataclasses.replace(config, static_mode=int(mode))")
    mode = StabilizationMode(int(config.static_mode))
    k = frames.shape[0]
    w = config.total_window
    if k > w:
        raise ValueError(f"chunk size {k} exceeds temporal window {w}")
    check_config(config)

    dev = carry.frames.device
    if frames.device != dev:
        raise ValueError(f"frames on {frames.device}, carry on {dev}: the offline step runs "
                         "on the carry's device; move the frames there")
    f32 = dict(dtype=torch.float32, device=dev)
    future = config.future_frames
    wh, ww = config.working_size
    center = torch.tensor([ww / 2.0, wh / 2.0]).to(dev, non_blocking=True)
    scale_factor = torch.tensor(config.scale_factor).to(dev, non_blocking=True)
    eye = torch.eye(3, **f32)
    frames = frames.to(torch.uint8)

    n0 = carry.n
    idxs = torch.arange(k, dtype=torch.int32, device=dev)
    ns = n0 + idxs
    k_ransac, k_lock = frame_keys(carry.key, ns)                 # (K, 2) each

    # 1. gray, pyramid and GFTT of the K frames (resize before gray)
    with stage("gray_pyramid"):
        grays = bgr_to_gray(resize_bilinear(frames.float(), wh, ww))
        pyrs = build_pyramid(grays, config.lk.pyramid_levels)
    with stage("gftt"):
        corners = good_features_to_track(grays, config.gftt)

    # 2. LK of the K pairs, one pair at a time; RANSAC of the K pairs at once
    pts_prev = torch.cat([carry.corners_prev[None], corners.points[:-1]])
    msk_prev = torch.cat([carry.corners_mask[None], corners.mask[:-1]])
    with stage("lk"):
        tracked = []
        for j in range(k):
            pyr_a = carry.pyr_prev if j == 0 else tuple(p[j - 1] for p in pyrs)
            tracked.append(lk_track(pyr_a, tuple(p[j] for p in pyrs), pts_prev[j],
                                    msk_prev[j], config.lk))
    with stage("fit"):
        ransac, t_rigid = _fit_inter_frame(
            pts_prev, torch.stack([t.points for t in tracked]),
            torch.stack([t.status for t in tracked]), k_ransac, config, center)
    have_prev = ns >= 1
    t_new = torch.where((have_prev & ransac.valid)[:, None, None], t_rigid, eye)

    # 3. the window after step j is ext[j+1 : j+w]; ext[i] holds the
    # transform into frame i - (w-1) + n0.  The very first frame does not
    # push in the streaming step, but its slot here is identity and invalid,
    # which every consumer reads the same way.
    ext = torch.cat([carry.transforms, t_new])
    ext_v = torch.cat([carry.tvalid, have_prev])
    n_after = ns + 1
    length = n_after.clamp(max=w)
    num_tr = length - 1
    zero_i = torch.zeros_like(length)
    pres = torch.where(length > future, length - future - 1, zero_i)
    pres_abs = torch.where(n_after > future, n_after - future - 1, zero_i)
    with stage("smoothing"):
        win = (torch.arange(k, device=dev)[:, None] + 1
               + torch.arange(w - 1, device=dev)[None, :])
        h_smooth = smoothing_homography(ext[win], ext_v[win], pres, num_tr,
                                        config.reference_compat)

    # 4. presentation frames, then the ring write
    pres_frames = _presentation_frames(carry.frames, frames, pres_abs, n0)
    carry.frames.index_copy_(0, torch.remainder(ns, w).long(), frames)

    # 5. lock transforms
    orb_ref, sift_ref, lock_prev_h = carry.orb_ref, carry.sift_ref, carry.lock_prev_h
    lock_matches = torch.zeros(k, dtype=torch.int32, device=dev)
    accum_h = eye
    accum_active = torch.zeros((), dtype=torch.bool, device=dev)
    if mode in ACCUM_MODES:
        with stage("lock"):
            h0 = torch.where(carry.accum_active, carry.accum_h, eye)
            advanced = (n_after - 1 - future) >= 1
            # the anchor step itself never advances
            adv = advanced & (carry.accum_active | (idxs >= 1))
            t_pres = ext[(pres_abs - n0 + (w - 1)).clamp(0, w - 2 + k).long()]
            m_seq = torch.where(adv[:, None, None], t_pres, eye)
            accum_seq = torch.matmul(_prefix_products(m_seq, left=True), h0)
            h_lock = _inv3x3(accum_seq)
            accum_h = accum_seq[-1]
            accum_active = torch.ones((), dtype=torch.bool, device=dev)
    elif mode in REGISTRATION_MODES:
        use_orb = mode == StabilizationMode.ORB_FULL_LOCK
        ref = orb_ref if use_orb else sift_ref
        with stage("lock"):
            with stage("lock_detect"):
                found = [detect_features(pres_frames[j].float(), config, use_orb)
                         for j in range(k)]
            # the reference is captured on the chunk's first frame if unset;
            # the sticky fallback runs frame to frame
            with stage("lock_register"):
                hs, matches = [], []
                for j, (feats, proc, c) in enumerate(found):
                    res = _registration_lock(feats.points, feats.desc, feats.mask, proc, ref,
                                             lock_prev_h, k_lock[j], config, c, use_orb,
                                             ecc_warp_fallback=False)
                    ref, lock_prev_h = res.ref, res.prev_h
                    hs.append(res.h_lock)
                    matches.append(res.n_matches)
        h_lock = torch.stack(hs)
        lock_matches = torch.stack(matches)
        if use_orb:
            orb_ref = ref
        else:
            sift_ref = ref
    else:   # GLOBAL_SMOOTHING: the lock is cleared every step
        h_lock = eye.expand(k, 3, 3)

    # 6. rotation split, mode select, rescale and one warp per frame
    h_stab, outputs, n_viol = stabilized_outputs(
        mode, h_smooth, h_lock, pres_frames, frames, ns == 0, center, scale_factor,
        config.warp_projective_fallback and mode not in BOUNDED_MODES)
    out_valid = torch.ones(k, dtype=torch.bool, device=dev)

    new_carry = EngineCarry(
        frames=carry.frames,
        transforms=ext[k:],
        tvalid=ext_v[k:],
        pyr_prev=tuple(p[-1] for p in pyrs),
        corners_prev=corners.points[-1],
        corners_mask=corners.mask[-1],
        n=n0 + k,
        mode=carry.mode,
        accum_h=accum_h,
        accum_active=accum_active,
        orb_ref=orb_ref,
        sift_ref=sift_ref,
        lock_prev_h=lock_prev_h,
        last_h=h_stab[-1],
        last_inliers=ransac.num_inliers[-1],
        last_lock_matches=lock_matches[-1],
        envelope_violations=carry.envelope_violations + n_viol,
        key=carry.key,
    )
    return new_carry, (outputs, out_valid)


def _offline_config(config: StabilizerConfig) -> StabilizerConfig:
    """LK's warps without the projective fallback, as the JAX offline path
    runs them: they remove the current global-motion estimate first, so
    their transforms are small by construction."""
    return dataclasses.replace(config, lk=dataclasses.replace(config.lk, warp_fallback=False))


@functools.lru_cache(maxsize=32)
def make_offline_fn(config: StabilizerConfig) -> Callable:
    """(carry, frames (K, Hf, Wf, C)) -> (carry, (outputs, valid)) for any
    K up to the window; one callable per config."""
    return functools.partial(offline_chunk_step, config=_offline_config(config))


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
