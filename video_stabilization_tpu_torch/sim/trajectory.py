"""Scripted shaky camera trajectories and a procedural floor texture.

Port of ``video_stabilization_tpu/sim/trajectory.py``.  ``jax.random`` draws
cannot be reproduced in PyTorch, so the random inputs come in as numpy
arrays: the texture from :func:`make_default_texture` (a numpy generator),
the shake from standard-normal noise arrays.  Given JAX's own noise, the
trajectory equals the JAX package's.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from video_stabilization_tpu_torch.sim.camera_engine import CameraParams


def make_default_texture(rng: np.random.Generator, size: int = 512) -> np.ndarray:
    """Corner-rich (size, size, 3) uint8 BGR floor texture: a coarse random
    mosaic, a fine checker and a smooth gradient (the JAX recipe, with numpy
    draws)."""
    cells = 16
    mosaic = rng.uniform(0.15, 0.95, (cells, cells, 3)).astype(np.float32)
    up = size // cells
    mosaic = np.repeat(np.repeat(mosaic, up, axis=0), up, axis=1)
    ys = np.arange(size)[:, None]
    xs = np.arange(size)[None, :]
    checker = (((ys // 8) + (xs // 8)) % 2).astype(np.float32) * 0.12
    grad = (xs / size * 0.15 + ys / size * 0.1).astype(np.float32)
    noise = rng.uniform(-0.05, 0.05, (size, size, 1)).astype(np.float32)
    img = np.clip(mosaic + checker[..., None] + grad[..., None] + noise, 0.0, 1.0)
    return (img * 255.0).astype(np.uint8)


def shake_trajectory(pos_noise: np.ndarray, roll_noise: np.ndarray, base: CameraParams,
                     pos_amplitude: float = 0.02, roll_amplitude: float = 1.0,
                     smoothness: float = 0.8, device=None) -> CameraParams:
    """AR(1) handheld shake around ``base`` from standard-normal noise
    ((n, 3) position, (n,) roll); a :class:`CameraParams` with a leading
    (n,) axis on ``device``."""
    pos = torch.tensor(np.asarray(pos_noise, np.float32), device=device) * pos_amplitude
    roll = torch.tensor(np.asarray(roll_noise, np.float32), device=device) * roll_amplitude
    n = pos.shape[0]
    base = base.to(pos.device)

    def ar1(x):
        y = torch.zeros_like(x[0])
        out = []
        for xi in x:
            y = smoothness * y + (1.0 - smoothness) * xi
            out.append(y)
        return torch.stack(out)

    return CameraParams(
        position=base.position[None, :] + ar1(pos),
        pan=base.pan.expand(n),
        tilt=base.tilt.expand(n),
        roll=base.roll + ar1(roll),
        focal_length=base.focal_length.expand(n),
    )


def smooth_pan_trajectory(pos_noise: np.ndarray, roll_noise: np.ndarray, base: CameraParams,
                          pan_per_frame: float = 0.1, shake_pos: float = 0.01,
                          shake_roll: float = 0.5, device=None) -> CameraParams:
    """An intentional slow lateral drift with handheld shake on top (the
    shake from :func:`shake_trajectory`'s standard-normal noise): global
    smoothing should keep the drift and remove the shake."""
    shaken = shake_trajectory(pos_noise, roll_noise, base, pos_amplitude=shake_pos,
                              roll_amplitude=shake_roll, device=device)
    n = shaken.position.shape[0]
    drift = torch.arange(n, dtype=torch.float32, device=shaken.position.device)
    drift = drift * pan_per_frame * 0.01
    pos = shaken.position.clone()
    pos[:, 0] += drift
    return replace(shaken, position=pos)
