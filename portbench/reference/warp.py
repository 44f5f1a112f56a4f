"""The general projective warp by explicit bilinear gather, and the 3x3
inverse: a frozen copy of the program's ``ops/warp.py`` (``_inv3x3``,
``pixel_grid``, ``warp_perspective``).  ``warp_perspective`` is the
equivalent of ``cv::warpPerspective(src, H, size, INTER_LINEAR,
BORDER_CONSTANT, value)``, of one image or of a batch with one homography
each; ``h`` maps source to destination pixels."""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse (adjugate / det, guarded determinant) of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    det = torch.where(det.abs() > _EPS, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([ca, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([cb, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([cc, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys (h, 1), xs (1, w)) f32 pixel coordinates."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def warp_perspective(
    src: torch.Tensor,
    h: torch.Tensor,
    out_shape: Tuple[int, int] | None = None,
    border_value: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """Warp ``src`` ((H, W) or (H, W, C)) by homography ``h`` (3, 3)
    (src->dst), bilinear with a constant border; same rank as ``src``.  A
    batch: ``h`` (B, 3, 3) with ``src`` (B, H, W[, C]) and a number, (C,) or
    (B, C) border; each item is what a call on it alone gives."""
    src = src.float()
    batched = h.dim() == 3
    if not batched:
        src, h = src[None], h[None]
    has_c = src.dim() == 4
    b, sh, sw = src.shape[0], src.shape[1], src.shape[2]
    out_h, out_w = out_shape if out_shape is not None else (sh, sw)
    hinv = _inv3x3(h.float())[:, :, :, None, None]             # (B, 3, 3, 1, 1)

    ys, xs = pixel_grid(out_h, out_w, src.device)
    denom = hinv[:, 2, 0] * xs + hinv[:, 2, 1] * ys + hinv[:, 2, 2]
    denom = torch.where(denom.abs() > _EPS, denom, torch.full_like(denom, _EPS))
    sx = (hinv[:, 0, 0] * xs + hinv[:, 0, 1] * ys + hinv[:, 0, 2]) / denom
    sy = (hinv[:, 1, 0] * xs + hinv[:, 1, 1] * ys + hinv[:, 1, 2]) / denom

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    inb = (sx >= 0.0) & (sx <= sw - 1.0) & (sy >= 0.0) & (sy <= sh - 1.0)

    # clamp in float before the integer cast so far-off samples cannot overflow
    x0c = x0.clamp(0, sw - 1).long()
    x1c = (x0 + 1).clamp(0, sw - 1).long()
    y0c = y0.clamp(0, sh - 1).long()
    y1c = (y0 + 1).clamp(0, sh - 1).long()
    item = torch.arange(b, device=src.device)[:, None, None]
    v00 = src[item, y0c, x0c]
    v01 = src[item, y0c, x1c]
    v10 = src[item, y1c, x0c]
    v11 = src[item, y1c, x1c]

    if has_c:
        fx = fx[..., None]
        fy = fy[..., None]
        inb = inb[..., None]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    out = top * (1.0 - fy) + bot * fy

    border = border_value
    if isinstance(border, torch.Tensor):
        border = border.float()
        if has_c:
            border = border[:, None, None] if border.dim() == 2 else border.expand(src.shape[3])
    out = torch.where(inb, out, border)
    return out if batched else out[0]


# --- gather-free affine warp (shear decomposition) ---------------------------



