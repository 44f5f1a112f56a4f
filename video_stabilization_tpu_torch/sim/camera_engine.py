"""Ray-cast floor-texture camera simulator with analytic ground truth.

Port of ``video_stabilization_tpu/sim/camera_engine.py``: a pinhole camera
over an infinitely tiled textured floor (z = 0) with sky above the horizon,
rendered on whatever device the texture lives on, the demo app's movement
and roll controls, and the exact inter-frame homography the floor induces
between two poses.  Angles are degrees; R =
Rz(roll)·Rx(tilt)·Ry(pan) maps camera to world.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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


DEFAULT_PARAMS = CameraParams.create()
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


# --- Movement (pure functions: params -> params) ----------------------------
# Column 2 of R is the camera's forward axis, column 0 its right axis, and
# column 1 points down (so "up" is its negation).

def _axis(params: CameraParams, col: int) -> torch.Tensor:
    return rotation_matrix(params.pan, params.tilt, params.roll)[:, col]


def move_forward(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return replace(params, position=params.position + _axis(params, 2) * (amount * move_speed))


def move_backward(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return replace(params, position=params.position - _axis(params, 2) * (amount * move_speed))


def move_right(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return replace(params, position=params.position + _axis(params, 0) * (amount * move_speed))


def move_left(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return replace(params, position=params.position - _axis(params, 0) * (amount * move_speed))


def move_up(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return replace(params, position=params.position - _axis(params, 1) * (amount * move_speed))


def move_down(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return replace(params, position=params.position + _axis(params, 1) * (amount * move_speed))


def roll_clockwise(params: CameraParams, amount, roll_speed=2.0) -> CameraParams:
    return replace(params, roll=params.roll - amount * roll_speed)


def roll_counterclockwise(params: CameraParams, amount, roll_speed=2.0) -> CameraParams:
    return replace(params, roll=params.roll + amount * roll_speed)


def plane_to_pixel_homography(params: CameraParams, height: int, width: int) -> torch.Tensor:
    """G = K·Rᵀ·M mapping floor coordinates (X, Y, 1) to pixels."""
    f = params.focal_length
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    k = _stack3([[f, zero, (width / 2.0) * one], [zero, f, (height / 2.0) * one],
                 [zero, zero, one]])
    r = rotation_matrix(params.pan, params.tilt, params.roll)
    c = params.position
    m = _stack3([[one, zero, -c[0]], [zero, one, -c[1]], [zero, zero, -c[2]]])
    return torch.matmul(k, torch.matmul(r.T, m))


def inter_frame_homography(params_a: CameraParams, params_b: CameraParams,
                           height: int, width: int) -> torch.Tensor:
    """Exact H with p_b ~ H·p_a for floor pixels (the ground-truth motion)."""
    ga = plane_to_pixel_homography(params_a, height, width)
    gb = plane_to_pixel_homography(params_b, height, width)
    h = torch.matmul(gb, torch.linalg.inv(ga))
    return h / h[2, 2]
