"""The footage generator: a frozen copy of the program's simulator
(``video_stabilization_tpu_torch/sim``): the procedural floor texture, the
AR(1) handheld shake around the demo app's start pose, and the ray-cast
render of a pinhole camera over the tiled floor.

It stays as it is when the program's simulator changes, so the footage a
seed gives is the same for every commit the benchmark measures.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SKY_COLOR_BGR = (230, 216, 173)
_EPS = 1e-9


@dataclass(frozen=True)
class CameraParams:
    """Camera pose + intrinsics; fields may carry a leading frame axis."""

    position: torch.Tensor       # (..., 3)
    pan: torch.Tensor            # (...,)
    tilt: torch.Tensor           # (...,)
    roll: torch.Tensor           # (...,)
    focal_length: torch.Tensor   # (...,)

    @staticmethod
    def create(position=(0.0, 0.0, 1.0), pan=0.0, tilt=105.0, roll=180.0,
               focal_length=1000.0, device=None) -> "CameraParams":
        def t(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)
        return CameraParams(t(position), t(pan), t(tilt), t(roll), t(focal_length))

    def __getitem__(self, i) -> "CameraParams":
        """Pose ``i`` of a trajectory."""
        return CameraParams(self.position[i], self.pan[i], self.tilt[i], self.roll[i],
                            self.focal_length[i])

    def to(self, device) -> "CameraParams":
        return CameraParams(*(getattr(self, k).to(device) for k in
                              ("position", "pan", "tilt", "roll", "focal_length")))


DEFAULT_APP_PARAMS = CameraParams.create(position=(0.5, -0.3, 0.7), pan=0.0,
                                         tilt=180.0, roll=180.0)


def _stack3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


def rotation_matrix(pan_deg, tilt_deg, roll_deg) -> torch.Tensor:
    """Camera->world rotation R = Rz(roll) · Rx(tilt) · Ry(pan)."""
    p, t, r = torch.deg2rad(pan_deg), torch.deg2rad(tilt_deg), torch.deg2rad(roll_deg)
    cp, sp = torch.cos(p), torch.sin(p)
    ct, st = torch.cos(t), torch.sin(t)
    cr, sr = torch.cos(r), torch.sin(r)
    o, z = torch.ones_like(cp), torch.zeros_like(cp)
    ry = _stack3([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    rx = _stack3([[o, z, z], [z, ct, -st], [z, st, ct]])
    rz = _stack3([[cr, -sr, z], [sr, cr, z], [z, z, o]])
    return torch.matmul(rz, torch.matmul(rx, ry))


def render_frame(texture: torch.Tensor, params: CameraParams, height: int,
                 width: int) -> torch.Tensor:
    """One (height, width, 3) uint8 BGR frame from a (th, tw, 3) uint8
    texture, on the texture's device."""
    th, tw = texture.shape[0], texture.shape[1]
    dev = texture.device
    r = rotation_matrix(params.pan, params.tilt, params.roll)
    cam = params.position
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    u = xs - width / 2.0
    v = ys - height / 2.0

    f = params.focal_length
    dx = r[0, 0] * u + r[0, 1] * v + r[0, 2] * f
    dy = r[1, 0] * u + r[1, 1] * v + r[1, 2] * f
    dz = r[2, 0] * u + r[2, 1] * v + r[2, 2] * f

    sky = (dz.abs() < _EPS) | (dz * cam[2] >= 0)
    t = -cam[2] / torch.where(sky, torch.ones_like(dz), dz)
    wx = cam[0] + t * dx
    wy = cam[1] + t * dy

    # tile 1.0 world units wide, 1/aspect high; nearest texel
    tile_y = wy * (tw / th)
    tex_u = wx - torch.floor(wx)
    tex_v = tile_y - torch.floor(tile_y)
    ix = (tex_u * tw).to(torch.int32).clamp(0, tw - 1).long()
    iy = (tex_v * th).to(torch.int32).clamp(0, th - 1).long()

    floor_bgr = texture[iy, ix]
    # a constant goes up without a blocking copy (a pageable source is
    # staged by the CUDA runtime before the call returns)
    sky_bgr = torch.tensor(SKY_COLOR_BGR, dtype=torch.uint8).to(dev, non_blocking=True)
    return torch.where(sky[..., None], sky_bgr, floor_bgr)


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
