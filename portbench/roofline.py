"""The bytes a kernel's work needs, from a configuration's shapes, and the
card's peaks (``peaks.json``): the yardstick of the ``*_roofline``
metrics, kept here so the count stays the same whatever implements the
kernel."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak(name: str) -> float:
    with open(PEAKS) as f:
        return float(json.load(f)[name])


def warp_bytes_per_frame(config: dict) -> int:
    """Bytes the warps of one stream-frame need, each input byte read once
    and each output byte written once: dense LK warps the next frame's
    float32 gray once at every pyramid level above the coarsest but the
    finest, and twice at the finest (working size halved per level, rounded
    up); the output warp takes the float32 (H, W, 3) presentation frame to a
    float32 frame of the same size.  4 bytes in and 4 out per value."""
    h = int(config["working_height"])
    w = int(round(config["frame_width"] * h / config["frame_height"]))
    levels = int(config.get("stabilizer", {}).get("lk", {}).get("pyramid_levels", 3))
    values = 0
    for level in range(levels):
        lh, lw = h, w
        for _ in range(level):
            lh, lw = -(-lh // 2), -(-lw // 2)
        values += lh * lw * (2 if level == 0 else 1)
    values += config["frame_height"] * config["frame_width"] * 3
    return 8 * values
