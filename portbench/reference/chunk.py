"""The stream-batched offline chunk of the plain reference: a frozen copy
of the program's ``engine/offline.py::offline_batched_chunk_step`` in
GLOBAL_SMOOTHING (the mode of ``serve_files`` and of the chunk that
``parallel.streams.make_sharded_offline_fn`` runs), in plain PyTorch.

K consecutive frames of each of S streams go through gray, pyramid, GFTT,
dense LK and RANSAC as one batch of S·K, then the window's smoothing and
one batched plain warp; the warps take the offline form's arguments (LK's
and the output's without the projective fallback).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from portbench.reference.config import StabilizerConfig
from portbench.reference.smoothing import smoothing_homography
from portbench.reference.step import (
    _fit_inter_frame,
    frame_keys,
    next_corners,
    stabilized_outputs,
    working_gray,
)
from portbench.reference.state import Carry
from portbench.reference.lk import lk_track
from portbench.reference.pyramid import build_pyramid


def offline_config(config: StabilizerConfig) -> StabilizerConfig:
    """The offline chunk's warp arguments in GLOBAL_SMOOTHING: LK's warps
    and the output warp without the projective fallback."""
    return dataclasses.replace(config, warp_projective_fallback=False,
                               lk=dataclasses.replace(config.lk, warp_fallback=False))


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


def offline_batched_chunk_step(carry: Carry, frames: torch.Tensor, config: StabilizerConfig
                               ) -> Tuple[Carry, torch.Tensor]:
    """Process K consecutive frames of each of S streams, (S, K, Hf, Wf, C)
    uint8 on the carry's device, with a carry of S streams -> (carry',
    outputs (S, K, Hf, Wf, C) u8).  ``config`` is :func:`offline_config`'s.
    ``carry.frames`` is updated in place."""
    s_n, k = frames.shape[:2]
    w = config.total_window
    if k > w:
        raise ValueError(f"chunk size {k} exceeds temporal window {w}")
    dev = carry.frames.device
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
    k_ransac, _ = frame_keys(carry.key[:, None, :], ns)          # (S, K, 2)

    # 1. gray, pyramid and GFTT of the S·K frames
    grays = working_gray(flat, config)
    pyrs = build_pyramid(grays, config.lk.pyramid_levels)
    corners = next_corners(grays, config)

    # 2. LK and RANSAC of the S·K pairs, each as one batch
    pts_prev = after_carry(carry.corners_prev, corners.points)
    tracked = lk_track([after_carry(a, b) for a, b in zip(carry.pyr_prev, pyrs)], pyrs,
                       pts_prev, after_carry(carry.corners_mask, corners.mask), config.lk)
    ransac, t_rigid = _fit_inter_frame(pts_prev, tracked.points, tracked.status,
                                       k_ransac.reshape(-1, 2), config, center)
    have_prev = ns >= 1
    t_new = torch.where((have_prev & per_stream(ransac.valid))[..., None, None],
                        per_stream(t_rigid), eye)

    # 3. the window after step j is ext[:, j+1 : j+w]; ext[:, i] holds the
    # transform into frame i - (w-1) + n0
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

    # 4. presentation frames, then the ring write (stream s, slot i at s·W + i)
    pres_frames = _presentation_frames(carry.frames, frames, pres_abs, n0)
    streams = torch.arange(s_n, device=dev)[:, None]
    ring = carry.frames.view((s_n * w,) + carry.frames.shape[2:])
    ring.index_copy_(0, (streams * w + torch.remainder(ns, w)).reshape(-1).long(), flat)

    # 5. rescale and one batched warp
    outputs = stabilized_outputs(h_smooth, pres_frames, frames, ns == 0, scale_factor,
                                 config.warp_projective_fallback)
    return Carry(frames=carry.frames, transforms=ext[:, k:], tvalid=ext_v[:, k:],
                 pyr_prev=tuple(per_stream(p)[:, -1] for p in pyrs),
                 corners_prev=per_stream(corners.points)[:, -1],
                 corners_mask=per_stream(corners.mask)[:, -1],
                 n=n0 + k, key=carry.key), outputs
