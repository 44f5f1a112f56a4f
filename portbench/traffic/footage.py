"""The one footage generator every traffic mix reads.

A mix (``traffic/<name>.json``) gives the footage's parameters: how many
frames each stream renders (``footage_frames``), the texture's size, the
shake's amplitudes and smoothness, and the offset of the trajectory seeds.
The configuration gives the streams and the frame size; the run's seed
gives the texture (``numpy.random.default_rng(seed)``) and stream s's
trajectory (``default_rng(trajectory_seed_offset + seed + s)``).  Frames
are rendered once on the card and replayed forward then backward
(:func:`pingpong`), so the replay never jumps in motion.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)


def render_streams(traffic: dict, height: int, width: int, streams: int, seed: int,
                   device) -> torch.Tensor:
    """(S, L, H, W, 3) uint8 BGR footage on ``device``."""
    n = int(traffic["footage_frames"])
    tex = torch.from_numpy(make_default_texture(np.random.default_rng(seed),
                                                int(traffic["texture_size"]))).to(device)
    out = torch.empty((streams, n, height, width, 3), dtype=torch.uint8, device=device)
    for s in range(streams):
        rng = np.random.default_rng(int(traffic["trajectory_seed_offset"]) + seed + s)
        traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                                DEFAULT_APP_PARAMS, pos_amplitude=traffic["pos_amplitude"],
                                roll_amplitude=traffic["roll_amplitude"],
                                smoothness=traffic["smoothness"], device=device)
        for i in range(n):
            out[s, i] = render_frame(tex, traj[i], height, width)
    return out


def pingpong(i: int, n: int) -> int:
    """The footage frame shown at step ``i`` of a replay of ``n`` frames,
    forward then backward: 0, 1, .., n-1, n-2, .., 1, 0, 1, .."""
    period = 2 * n - 2
    r = i % period
    return r if r < n else period - r


def pingpong_indices(first: int, count: int, n: int) -> list:
    """The footage frames of steps ``first .. first + count - 1``."""
    return [pingpong(i, n) for i in range(first, first + count)]


def encode_c420(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR -> (N, H·W·3/2) uint8 Y|U|V planes of C420
    Y4M frames, computed on the frames' device: BT.601 in float32, chroma
    as the mean of each 2x2 block.  These bytes are the input; the program
    and the reference both decode them."""
    n, h, w = frames.shape[:3]
    f = frames.float()
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 128.0 + 0.564 * (b - y)
    v = 128.0 + 0.713 * (r - y)
    u = u.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    v = v.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    return torch.cat([p.clamp(0, 255).to(torch.uint8).reshape(n, -1) for p in (y, u, v)], 1)
