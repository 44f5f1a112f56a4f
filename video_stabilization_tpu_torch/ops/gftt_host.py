"""Host-side numpy replica of ``cv2.goodFeaturesToTrack``, element-exact.

The port's own copy of ``video_stabilization_tpu/ops/gftt_host.py`` (the
port imports nothing of the JAX package).  The reference-compat referee
with ``gftt.selection="host"`` feeds the cv2exact RANSAC replica
(``motion/cv2_ransac.py``) the same corner list, in the same lane order, as
the reference pipeline, so the hypothesis stream stays synchronized; the
stage runs on the host, where cv2's arithmetic can be replicated exactly:

- gray: cv2's fixed-point u8 resize at integer factors (lattice sampling;
  even k sums the centre pair, one final ``(sum + d/2) >> log2(d)``), then
  ``(3735 B + 19235 G + 9798 R + 16384) >> 15``;
- Sobel dx by a fused multiply-add emulated in float64, dy rows in float64;
- 3x3 box sums of all nine taps in float64, one float32 round;
- min eigenvalue in float32; THRESH_TOZERO at ``float(maxVal · quality)``,
  3x3 dilate-compare NMS, interior-only row-major scan;
- response sort with ties by DESCENDING scan index (cv2's pointer order);
- greedy suppression on a ``cvRound(minDistance)`` grid, 3x3 cell
  neighbourhood, strict ``< minDistance²``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gray_u8_cv2exact_np(frame_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """numpy twin of ops/image.py ``gray_u8_cv2exact`` (see its docstring);
    returns the (out_h, out_w) uint8 gray cv2's resize+cvtColor produces."""
    h, w = frame_u8.shape[:2]
    if out_h > h or h % out_h or out_w > w or w % out_w:
        raise ValueError(
            f"integer downscales only, got {h}x{w} -> {out_h}x{out_w}")
    x = frame_u8.astype(np.int64)
    shift = 0
    for axis, k, size in ((0, h // out_h, out_h), (1, w // out_w, out_w)):
        if k == 1:
            continue
        limit = (size - 1) * k + 1
        sl = [slice(None)] * x.ndim
        if k % 2 == 1:
            st = (k - 1) // 2
            sl[axis] = slice(st, st + limit, k)
            x = x[tuple(sl)]
        else:
            sl[axis] = slice(k // 2 - 1, k // 2 - 1 + limit, k)
            a = x[tuple(sl)]
            sl[axis] = slice(k // 2, k // 2 + limit, k)
            b = x[tuple(sl)]
            x = a + b
            shift += 1
    if shift:
        x = (x + (1 << (shift - 1))) >> shift
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(np.uint8)


def _fma32(a, b, c):
    """float32 fused multiply-add via float64 (exact: the f64 product of two
    f32 is exact, and the single final round matches hardware fma except in
    ~2^-29-rare double-rounding cases, none observed in validation)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def min_eig_response_np(gray_u8: np.ndarray) -> np.ndarray:
    """cv2.cornerMinEigenVal(gray, blockSize=3, ksize=3) — element-exact."""
    scale = 1.0 / (4 * 3 * 255)
    s = np.float32(scale)
    s2 = np.float32(2 * scale)
    xp = np.pad(gray_u8.astype(np.float32), 1, mode="reflect")
    rows_dx = xp[:, 2:] - xp[:, :-2]                       # int-valued, exact
    dx = _fma32(rows_dx[0:-2] + rows_dx[2:], s, rows_dx[1:-1] * s2)
    rows_dy = ((xp[:, 0:-2].astype(np.float64) + xp[:, 2:]) * scale
               + xp[:, 1:-1].astype(np.float64) * (2 * scale)).astype(np.float32)
    dy = rows_dy[2:] - rows_dy[0:-2]

    cxx = dx * dx
    cxy = dx * dy
    cyy = dy * dy

    h, w = gray_u8.shape

    def box(a):
        ap = np.pad(a, 1, mode="reflect").astype(np.float64)
        acc = np.zeros((h, w), np.float64)
        for oy in range(3):
            for ox in range(3):
                acc += ap[oy:oy + h, ox:ox + w]
        return acc.astype(np.float32)

    a2 = box(cxx) * np.float32(0.5)
    b2 = box(cxy)
    c2 = box(cyy) * np.float32(0.5)
    return (a2 + c2) - np.sqrt((a2 - c2) * (a2 - c2) + b2 * b2)


def good_features_to_track_np(
    gray_u8: np.ndarray,
    max_corners: int = 1300,
    quality_level: float = 0.01,
    min_distance: float = 5.0,
) -> np.ndarray:
    """cv2.goodFeaturesToTrack(gray, maxCorners, quality, minDistance,
    blockSize=3) — identical corner list, identical order.  Returns (N, 2)
    float32 (x, y)."""
    eig = min_eig_response_np(gray_u8)
    h, w = eig.shape
    thr = np.float32(np.float64(eig.max()) * quality_level)
    keep = eig > thr
    pad = np.pad(eig, 1, mode="constant", constant_values=-np.inf)
    dil = eig.copy()
    for oy in range(3):
        for ox in range(3):
            np.maximum(dil, pad[oy:oy + h, ox:ox + w], out=dil)
    cand = keep & (eig == dil)
    cand[0, :] = cand[-1, :] = False
    cand[:, 0] = cand[:, -1] = False
    ys, xs = np.nonzero(cand)                       # row-major scan order
    vals = eig[ys, xs]

    # value desc; ties by DESCENDING scan index (greaterThanPtr compares the
    # eig POINTERS on equal responses — OpenCV's determinism fix)
    order = np.lexsort((-np.arange(len(vals)), -vals.astype(np.float64)))
    xs = xs[order]
    ys = ys[order]

    cell = max(1, int(round(min_distance)))
    md2 = min_distance * min_distance
    grid: dict = {}
    out = []
    for x, y in zip(xs, ys):
        gx = int(x) // cell
        gy = int(y) // cell
        ok = True
        for yy in range(max(gy - 1, 0), gy + 2):
            if not ok:
                break
            for xx in range(max(gx - 1, 0), gx + 2):
                for (px, py) in grid.get((xx, yy), ()):
                    ddx = x - px
                    ddy = y - py
                    if ddx * ddx + ddy * ddy < md2:
                        ok = False
                        break
                if not ok:
                    break
        if ok:
            grid.setdefault((gx, gy), []).append((float(x), float(y)))
            out.append((float(x), float(y)))
            if len(out) >= max_corners:
                break
    if not out:
        return np.zeros((0, 2), np.float32)
    return np.asarray(out, np.float32)


def detect_corners_host(
    frame_u8: np.ndarray,
    working_size: Tuple[int, int],
    max_features: int,
    quality_level: float,
    min_distance: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full host corner stage for the compat engine: exact gray -> exact
    GFTT -> fixed-capacity (max_features, 2) lanes + validity mask."""
    wh, ww = working_size
    gray = gray_u8_cv2exact_np(np.asarray(frame_u8, np.uint8), wh, ww)
    pts = good_features_to_track_np(gray, max_features, quality_level,
                                    min_distance)
    out = np.zeros((max_features, 2), np.float32)
    mask = np.zeros(max_features, bool)
    n = min(len(pts), max_features)
    out[:n] = pts[:n]
    mask[:n] = True
    return out, mask
