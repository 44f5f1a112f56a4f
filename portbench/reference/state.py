"""The reference's carry: the state of GLOBAL_SMOOTHING streams.

A frozen copy of what the program's ``engine/state.py`` keeps for this
mode: the ring of the window's frames, the window's inter-frame transforms,
the previous frame's pyramid and corners, the frame counter and the RANSAC
key.  With a leading (S,) on every tensor it holds S streams.  Nothing else
carries from frame to frame in this mode, so a carry started at frame
``n0`` with these fields fresh gives, from frame ``n0 + W`` on (W the
window), the outputs that a carry started at frame 0 gives.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Tuple

import torch

from portbench.reference import prng
from portbench.reference.config import StabilizerConfig


@dataclass
class Carry:
    frames: torch.Tensor        # (W, Hf, Wf, C) uint8, circular by abs index % W
    transforms: torch.Tensor    # (W-1, 3, 3) f32, newest last
    tvalid: torch.Tensor        # (W-1,) bool
    pyr_prev: Tuple[torch.Tensor, ...]  # working-res gray pyramid
    corners_prev: torch.Tensor  # (N, 2) f32
    corners_mask: torch.Tensor  # (N,) bool
    n: torch.Tensor             # () int32 frames ingested
    key: torch.Tensor           # (2,) int64 threefry key words


def init_carry(config: StabilizerConfig, key_words: torch.Tensor, device,
               n0: int = 0) -> Carry:
    """A fresh carry on ``device`` with the (2,) threefry ``key_words``,
    about to ingest frame ``n0``."""
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
    return Carry(
        frames=torch.zeros((w, hf, wf, c), dtype=torch.uint8, device=device),
        transforms=torch.eye(3, **f32).expand(w - 1, 3, 3).clone(),
        tvalid=torch.zeros((w - 1,), dtype=torch.bool, device=device),
        pyr_prev=tuple(pyr),
        corners_prev=torch.zeros((n_feat, 2), **f32),
        corners_mask=torch.zeros((n_feat,), dtype=torch.bool, device=device),
        n=torch.tensor(n0, dtype=torch.int32, device=device),
        key=torch.as_tensor(key_words, dtype=torch.int64).to(device),
    )


def map_carry(fn, *carries):
    """The carry (or pyramid tuple) whose every tensor is ``fn`` of the
    corresponding tensors of ``carries``."""
    first = carries[0]
    if isinstance(first, torch.Tensor):
        return fn(*carries)
    if isinstance(first, tuple):
        return tuple(map_carry(fn, *parts) for parts in zip(*carries))
    return type(first)(**{f.name: map_carry(fn, *(getattr(c, f.name) for c in carries))
                          for f in fields(first)})


def init_batched_carry(config: StabilizerConfig, n_streams: int, key_words: torch.Tensor,
                       device, n0: int = 0) -> Carry:
    """A fresh carry of ``n_streams`` streams about to ingest frame ``n0``;
    stream s has the key ``prng.split(key_words, n_streams)[s]``, as the
    program's ``parallel/streams.py::init_batched_carry``."""
    keys = prng.split(torch.as_tensor(key_words, dtype=torch.int64), n_streams)
    one = init_carry(config, keys[0], device, n0)
    carry = map_carry(lambda x: x[None].expand((n_streams,) + x.shape).clone(), one)
    carry.key = keys.to(device)
    return carry
