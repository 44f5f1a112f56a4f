"""The Y4M frame encoding of the plain reference: a frozen copy of the
program's ``io/video.py::encode_y4m_planes``."""

from __future__ import annotations

import numpy as np


def encode_y4m_planes(frame_bgr: np.ndarray, c420: bool) -> bytes:
    """One (H, W, 3) uint8 BGR frame as the Y|U|V bytes of a Y4M frame:
    BT.601 in f32, C420 chroma as the mean of each 2x2 block."""
    h, w = frame_bgr.shape[:2]
    f = frame_bgr.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 128.0 + 0.564 * (b - y)
    v = 128.0 + 0.713 * (r - y)
    if c420:
        u = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        v = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    return b"".join(np.clip(plane, 0, 255).astype(np.uint8).tobytes() for plane in (y, u, v))
