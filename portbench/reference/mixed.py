"""The batched step in mixed modes, for the plain reference: S streams one
frame at a time, each in its own mode of GLOBAL_SMOOTHING,
TRANSLATION_LOCK and ROTATION_LOCK, with mode switches between steps.  A
frozen copy, in plain PyTorch, of what the program's batched step runs
without a pinned mode (``parallel/streams.py::make_batched_step_fn``, the
form "batched_mixed" of ``engine/offline.py``'s one body at K = 1) and of
its switch (``parallel.set_stream_mode``, the reference app's mode keys,
src/stabilizer.cpp:55-70).

Per step, on top of the smoothing stages of ``chunk.py`` (LK's warps
without the projective fallback):
  - the accumulated lock over every stream, kept where the stream's mode
    locks (TRANSLATION_LOCK, ROTATION_LOCK): its anchor is the first step
    after the stream enters the mode, and from the next step it takes the
    transform into each presentation frame (newest factor on the left);
  - the rotation split of the lock's inverse and each stream's stabilizing
    homography: the smoothing homography, the lock with its rotation
    cancelled (translation lock) or the lock's rotation alone (rotation
    lock), selected per stream;
  - the output warp with its projective fallback, in every mode.
A switch sets the stream's mode and clears its lock; its window stays.

A batch's summation order follows its shape, so the reference runs the
program's batch of S at K = 1.  It keeps no frame ring: a presentation
frame is the footage's frame of its step, and the full-resolution warps
run only for the steps whose outputs are asked for (no state reads an
output).

Where a replay starts: a stream's output depends on the window's
transforms (steps ``first - (W - 1) + 1 ..``) and, in a lock mode, on the
transforms into the presentation frames since its anchor ``a`` (frames
``a + 1 - F ..``, F the future frames), each computed from the frame
before it.  So a fresh carry at step ``min(first - (W - 1), a - F)`` over
the streams locked at ``first`` gives the outputs of a run from step 0
(:func:`start_step`); with a switch every P steps on each stream that is
at most P + F steps before ``first``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch

from portbench.reference import set_precision
from portbench.reference.config import StabilizationMode, StabilizerConfig
from portbench.reference.homography import (
    HomographyParams, compose_homography, decompose_homography)
from portbench.reference.lk import lk_track
from portbench.reference.pyramid import build_pyramid
from portbench.reference.smoothing import _prefix_products, smoothing_homography
from portbench.reference.state import init_carry, map_carry
from portbench.reference.step import (
    _fit_inter_frame, check_config, frame_keys, next_corners, working_gray)
from portbench.reference.affine_warp import warp_affine
from portbench.reference.warp import _inv3x3
from portbench.reference import prng

M = StabilizationMode
MODES = (M.GLOBAL_SMOOTHING, M.TRANSLATION_LOCK, M.ROTATION_LOCK)
LOCKING = (M.TRANSLATION_LOCK, M.ROTATION_LOCK)

# switches made before a step: {step: [(stream, mode), ...]}
Switches = Dict[int, Sequence[Tuple[int, int]]]


@dataclass
class MixedCarry:
    """The state of S streams in mixed modes (every tensor (S, ...)): the
    smoothing stages' (``state.py``, without the frame ring), each stream's
    mode and its accumulated lock."""

    transforms: torch.Tensor    # (S, W-1, 3, 3) f32, newest last
    tvalid: torch.Tensor        # (S, W-1) bool
    pyr_prev: Tuple[torch.Tensor, ...]
    corners_prev: torch.Tensor  # (S, N, 2) f32
    corners_mask: torch.Tensor  # (S, N) bool
    n: torch.Tensor             # (S,) int32 frames ingested
    key: torch.Tensor           # (S, 2) int64
    mode: torch.Tensor          # (S,) int32
    accum_h: torch.Tensor       # (S, 3, 3) f32
    accum_active: torch.Tensor  # (S,) bool


def check_modes(config: StabilizerConfig, modes) -> None:
    """Refuse what this reference does not cover."""
    check_config(config, M.GLOBAL_SMOOTHING)
    bad = sorted({int(m) for m in modes} - {int(m) for m in MODES})
    if bad:
        raise ValueError(f"modes {bad}: the mixed reference covers "
                         f"{[m.name for m in MODES]} only")


def init_mixed_carry(config: StabilizerConfig, modes: Sequence[int], key_words, device,
                     n0: int = 0) -> MixedCarry:
    """A fresh carry of ``len(modes)`` streams in ``modes`` about to ingest
    frame ``n0``, lock cleared; stream s has the key
    ``prng.split(key_words, S)[s]``."""
    s_n = len(modes)
    keys = prng.split(torch.as_tensor(key_words, dtype=torch.int64), s_n)
    one = init_carry(config, keys[0], device, n0)
    many = map_carry(lambda x: x[None].expand((s_n,) + x.shape).clone(), one)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    return MixedCarry(
        transforms=many.transforms, tvalid=many.tvalid, pyr_prev=many.pyr_prev,
        corners_prev=many.corners_prev, corners_mask=many.corners_mask, n=many.n,
        key=keys.to(device), mode=torch.tensor([int(m) for m in modes], dtype=torch.int32,
                                               device=device),
        accum_h=eye.expand(s_n, 3, 3).clone(),
        accum_active=torch.zeros(s_n, dtype=torch.bool, device=device))


def switch(carry: MixedCarry, s: int, mode: int) -> MixedCarry:
    """Stream ``s`` in ``mode`` with its lock cleared; the window stays."""
    mode_t, accum_h, active = carry.mode.clone(), carry.accum_h.clone(), carry.accum_active.clone()
    mode_t[s] = int(mode)
    accum_h[s] = torch.eye(3, dtype=torch.float32, device=accum_h.device)
    active[s] = False
    return dataclasses.replace(carry, mode=mode_t, accum_h=accum_h, accum_active=active)


def _rotation_about(theta: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Rotation by -theta (y-down) about ``center`` as a 3x3 homography."""
    zero2 = torch.zeros(theta.shape + (2,), dtype=theta.dtype, device=theta.device)
    p = HomographyParams(scale=torch.ones_like(theta), theta=-theta,
                         k=torch.ones_like(theta), delta=torch.zeros_like(theta),
                         t=zero2, v=zero2)
    return compose_homography(p, center)


def mixed_step(carry: MixedCarry, frames: torch.Tensor, config: StabilizerConfig,
               pres_frames: torch.Tensor | None = None):
    """One frame of each of S streams, (S, Hf, Wf, C) uint8 -> (carry',
    outputs (S, Hf, Wf, C) u8, or None without ``pres_frames``, the (S,
    Hf, Wf, C) presentation frames of this step)."""
    s_n, k = frames.shape[0], 1
    w = config.total_window
    dev = frames.device
    f32 = dict(dtype=torch.float32, device=dev)
    future = config.future_frames
    wh, ww = config.working_size
    center = torch.tensor([ww / 2.0, wh / 2.0]).to(dev, non_blocking=True)
    scale_factor = torch.tensor(config.scale_factor).to(dev, non_blocking=True)
    eye = torch.eye(3, **f32)
    frames = frames.to(torch.uint8)

    def per_stream(x):                  # (S, ...) -> (S, 1, ...)
        return x.reshape((s_n, k) + x.shape[1:])

    n0 = carry.n
    idxs = torch.arange(k, dtype=torch.int32, device=dev)
    ns = n0[:, None] + idxs                                      # (S, 1)
    k_ransac, _ = frame_keys(carry.key[:, None, :], ns)

    # gray, pyramid, corners; LK and RANSAC of the S pairs
    grays = working_gray(frames, config)
    pyrs = build_pyramid(grays, config.lk.pyramid_levels)
    corners = next_corners(grays, config)
    lk = dataclasses.replace(config.lk, warp_fallback=False)
    tracked = lk_track(list(carry.pyr_prev), pyrs, carry.corners_prev, carry.corners_mask, lk)
    ransac, t_rigid = _fit_inter_frame(carry.corners_prev, tracked.points, tracked.status,
                                       k_ransac.reshape(-1, 2), config, center)
    have_prev = ns >= 1
    t_new = torch.where((have_prev & per_stream(ransac.valid))[..., None, None],
                        per_stream(t_rigid), eye)

    # the window and the smoothing homography
    ext = torch.cat([carry.transforms, t_new], 1)
    ext_v = torch.cat([carry.tvalid, have_prev], 1)
    n_after = ns + 1
    length = n_after.clamp(max=w)
    num_tr = length - 1
    zero_i = torch.zeros_like(length)
    pres = torch.where(length > future, length - future - 1, zero_i)
    pres_abs = torch.where(n_after > future, n_after - future - 1, zero_i)
    win = torch.arange(k, device=dev)[:, None] + 1 + torch.arange(w - 1, device=dev)[None, :]
    h_smooth = smoothing_homography(ext[:, win], ext_v[:, win], pres, num_tr, False)

    # the accumulated lock over every stream, kept where the mode locks
    streams = torch.arange(s_n, device=dev)[:, None]
    h0 = torch.where(carry.accum_active[:, None, None], carry.accum_h, eye)
    advanced = (n_after - 1 - future) >= 1
    adv = advanced & (carry.accum_active[:, None] | (idxs >= 1))
    t_pres = ext[streams, (pres_abs - n0[:, None] + (w - 1)).clamp(0, w - 2 + k).long()]
    m_seq = torch.where(adv[..., None, None], t_pres, eye)
    accum_seq = torch.matmul(_prefix_products(m_seq, left=True), h0[:, None])
    locking = torch.zeros(s_n, dtype=torch.bool, device=dev)
    for m in LOCKING:
        locking = locking | (carry.mode == int(m))
    h_lock = torch.where(locking[:, None, None, None], _inv3x3(accum_seq), eye)
    accum_h = torch.where(locking[:, None, None], accum_seq[:, -1], eye)

    new = dataclasses.replace(
        carry, transforms=ext[:, k:], tvalid=ext_v[:, k:],
        pyr_prev=tuple(per_stream(p)[:, -1] for p in pyrs),
        corners_prev=per_stream(corners.points)[:, -1],
        corners_mask=per_stream(corners.mask)[:, -1], n=n0 + k, accum_h=accum_h,
        accum_active=locking)
    if pres_frames is None:
        return new, None

    # the rotation split, each stream's homography, one batched warp
    lock_params, lock_ok = decompose_homography(h_lock, center)
    h_lock = torch.where(lock_ok[..., None, None], h_lock, eye)
    translation_lock = torch.matmul(_rotation_about(lock_params.theta, center), h_lock)
    rotation_lock = _rotation_about(-lock_params.theta, center)
    m = carry.mode[:, None][..., None, None]
    h_stab = torch.where(
        m == int(M.GLOBAL_SMOOTHING), h_smooth, torch.where(
            m == int(M.TRANSLATION_LOCK), translation_lock, torch.where(
                m == int(M.ROTATION_LOCK), rotation_lock, h_lock)))
    h_scaled = h_stab.clone()
    h_scaled[..., 0:2, 2] = h_stab[..., 0:2, 2] / scale_factor
    pres_f = pres_frames.float()
    border = 0.5 * pres_f.mean(dim=(1, 2))
    out = warp_affine(pres_f, h_scaled.reshape(-1, 3, 3), border_value=border,
                      projective_fallback=config.warp_projective_fallback)
    warped_u8 = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    outputs = torch.where((ns == 0).reshape(-1)[:, None, None, None], frames, warped_u8)
    return new, outputs


def presentation_step(j: int, future: int) -> int:
    """The frame that step ``j``'s output shows."""
    return j - future if j + 1 > future else 0


def modes_at(modes0: Sequence[int], switches: Switches, j: int) -> list:
    """Each stream's mode at step ``j``: after the switches of steps ``<= j``."""
    modes = [int(m) for m in modes0]
    for step in sorted(t for t in switches if t <= j):
        for s, m in switches[step]:
            modes[s] = int(m)
    return modes


def start_step(config: StabilizerConfig, modes0: Sequence[int], switches: Switches,
               first: int) -> int:
    """The latest step from which a fresh carry gives step ``first``'s
    outputs and those after it: the window's start, and each stream locked
    at ``first`` F steps before its anchor (its last switch up to
    ``first``, else step 0)."""
    start = first - (config.total_window - 1)
    for s, m in enumerate(modes_at(modes0, switches, first)):
        if m in LOCKING:
            anchor = max([t for t in switches if t <= first
                          and any(who == s for who, _ in switches[t])], default=0)
            start = min(start, anchor - config.future_frames)
    return max(0, start)


def mixed_outputs(config: StabilizerConfig, modes0: Sequence[int], switches: Switches,
                  frames_at: Callable, key_words, first: int, stop: int, device,
                  precision: str = "float32", start: int | None = None) -> torch.Tensor:
    """(S, stop - first, Hf, Wf, C) uint8: the mixed batched step's outputs
    of steps ``first .. stop - 1`` of S = ``len(modes0)`` streams that start
    in ``modes0`` and switch as ``switches`` says (before the step),
    replayed from :func:`start_step` (or ``start``); ``frames_at(steps)``
    is (S, len(steps), Hf, Wf, C).  ``config`` is the configuration's
    (the output warp keeps its projective fallback; LK's warps drop it)."""
    check_modes(config, list(modes0) + [m for sw in switches.values() for _, m in sw])
    set_precision(precision)
    try:
        t0 = start_step(config, modes0, switches, first) if start is None else start
        carry = init_mixed_carry(config, modes_at(modes0, switches, t0), key_words, device,
                                 t0)
        outs = []
        for j in range(t0, stop):
            if j > t0:
                for s, m in switches.get(j, ()):
                    carry = switch(carry, s, m)
            pres = None
            if j >= first:
                pres = frames_at([presentation_step(j, config.future_frames)])[:, 0].to(device)
            carry, out = mixed_step(carry, frames_at([j])[:, 0].to(device), config, pres)
            if out is not None:
                outs.append(out)
        return torch.stack(outs, 1)
    finally:
        set_precision("float32")
