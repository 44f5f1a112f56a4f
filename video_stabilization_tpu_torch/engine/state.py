"""Engine carry: the explicit per-stream state, as a dataclass of tensors.

Port of ``video_stabilization_tpu/engine/state.py``.  The fields, shapes and
dtypes are the JAX package's, including the empty ORB/SIFT references, so a
carry converts field for field (``engine/checkpoint.py``).  The PRNG key is
its two 32-bit words in an int64 (2,) tensor (``utils/prng.py``).

Unlike the JAX carry, the port's carry is mutable: ``stabilize_step`` writes
the new frame into the ``frames`` ring in place rather than copying a ring
of full-resolution frames every step.

A carry of S streams (``parallel/streams.py``) has a leading (S,) on every
tensor; :func:`map_carry` maps a function over the tensors of one or more
carries (or of their parts), as ``jax.tree.map`` does for the JAX carry.
Sharded over a mesh of D devices, a carry, or a step's outputs, is a
:class:`Sharded` value: D parts of S/D streams each, one per device;
:func:`unshard` brings one to a single device in stream order.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, Tuple

import torch

from video_stabilization_tpu_torch.config import StabilizerConfig


@dataclass
class RegistrationRef:
    """Reference-frame features of the ORB/SIFT locks."""

    points: torch.Tensor   # (N, 2) f32
    desc: torch.Tensor     # (N, D) int8 (ORB) / f32 (SIFT)
    mask: torch.Tensor     # (N,) bool
    gray: torch.Tensor     # (wh, ww) f32
    is_set: torch.Tensor   # () bool


@dataclass
class EngineCarry:
    frames: torch.Tensor        # (W, Hf, Wf, C) uint8, circular by abs index % W
    transforms: torch.Tensor    # (W-1, 3, 3) f32, newest last
    tvalid: torch.Tensor        # (W-1,) bool
    pyr_prev: Tuple[torch.Tensor, ...]  # working-res gray pyramid
    corners_prev: torch.Tensor  # (N, 2) f32
    corners_mask: torch.Tensor  # (N,) bool
    n: torch.Tensor             # () int32 frames ingested
    mode: torch.Tensor          # () int32 StabilizationMode
    accum_h: torch.Tensor       # (3, 3) f32
    accum_active: torch.Tensor  # () bool
    orb_ref: RegistrationRef
    sift_ref: RegistrationRef
    lock_prev_h: torch.Tensor   # (3, 3) f32
    last_h: torch.Tensor        # (3, 3) f32 last applied transform (working res)
    last_inliers: torch.Tensor  # () int32
    last_lock_matches: torch.Tensor  # () int32
    envelope_violations: torch.Tensor  # () int32
    key: torch.Tensor           # (2,) int64 threefry key words


def init_carry(config: StabilizerConfig, mode: int, key_words: torch.Tensor,
               device) -> EngineCarry:
    """A fresh carry on ``device`` with the (2,) threefry ``key_words``."""
    w = config.total_window
    hf, wf, c = config.frame_height, config.frame_width, config.channels
    wh, ww = config.working_size
    n_feat = config.gftt.max_features
    f32 = dict(dtype=torch.float32, device=device)

    pyr = []
    h_l, w_l = wh, ww
    for _ in range(config.lk.pyramid_levels + 1):
        pyr.append(torch.zeros((h_l, w_l), **f32))
        h_l, w_l = -(-h_l // 2), -(-w_l // 2)

    def empty_ref(n_kp: int, desc_dim: int, desc_dtype) -> RegistrationRef:
        return RegistrationRef(
            points=torch.zeros((n_kp, 2), **f32),
            desc=torch.zeros((n_kp, desc_dim), dtype=desc_dtype, device=device),
            mask=torch.zeros((n_kp,), dtype=torch.bool, device=device),
            gray=torch.zeros((wh, ww), **f32),
            is_set=torch.zeros((), dtype=torch.bool, device=device),
        )

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    eye = torch.eye(3, **f32)
    return EngineCarry(
        frames=torch.zeros((w, hf, wf, c), dtype=torch.uint8, device=device),
        transforms=eye.expand(w - 1, 3, 3).clone(),
        tvalid=torch.zeros((w - 1,), dtype=torch.bool, device=device),
        pyr_prev=tuple(pyr),
        corners_prev=torch.zeros((n_feat, 2), **f32),
        corners_mask=torch.zeros((n_feat,), dtype=torch.bool, device=device),
        n=i32(0),
        mode=i32(int(mode)),
        accum_h=eye.clone(),
        accum_active=torch.zeros((), dtype=torch.bool, device=device),
        orb_ref=empty_ref(config.orb.max_features, 256, torch.int8),
        sift_ref=empty_ref(config.sift.max_features, 128, torch.float32),
        lock_prev_h=eye.clone(),
        last_h=eye.clone(),
        last_inliers=i32(0),
        last_lock_matches=i32(0),
        envelope_violations=i32(0),
        key=torch.as_tensor(key_words, dtype=torch.int64).to(device),
    )


def map_carry(fn: Callable, *carries):
    """The carry (or ``RegistrationRef``, or pyramid tuple) whose every
    tensor is ``fn`` of the corresponding tensors of ``carries``."""
    first = carries[0]
    if isinstance(first, torch.Tensor):
        return fn(*carries)
    if isinstance(first, tuple):
        return tuple(map_carry(fn, *parts) for parts in zip(*carries))
    return type(first)(**{f.name: map_carry(fn, *(getattr(c, f.name) for c in carries))
                          for f in fields(first)})


def carry_stream(carry, s: int):
    """Stream ``s`` of a batched carry (or of a :class:`Sharded` one) as a
    carry of its own: a copy, so a step on it leaves the batched carry (and
    its frame ring) untouched."""
    if isinstance(carry, Sharded):
        per = carry.parts[0].n.shape[0]
        return carry_stream(carry.parts[s // per], s % per)
    return map_carry(lambda x: x[s].clone(), carry)


@dataclass(frozen=True)
class Sharded:
    """A stream-sharded value over a mesh of D devices
    (``parallel/streams.py``): ``parts[d]``, on the mesh's device d, holds
    streams ``d·S/D`` to ``(d+1)·S/D − 1`` of the S, each part a batched
    carry or a tensor with a leading stream dimension.  :func:`map_carry`
    maps over it part by part; :func:`unshard` joins the parts."""

    parts: tuple


def unshard(value, device="cpu"):
    """``value`` (a tensor, a carry, or a :class:`Sharded` one of either)
    on ``device`` with its streams in order: the parts of a Sharded value
    are moved there and joined along the stream dimension."""
    if isinstance(value, Sharded):
        return map_carry(lambda *xs: torch.cat([x.to(device) for x in xs]), *value.parts)
    return map_carry(lambda x: x.to(device), value)
