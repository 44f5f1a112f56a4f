"""General projective warp by explicit bilinear gather, and the gather-free
affine warp by shear decomposition.

Port of ``video_stabilization_tpu/ops/warp.py`` (``_inv3x3``,
``warp_perspective``, ``warp_affine_shear`` with ``_shear_rows`` and
``_resample_axis``).  ``warp_perspective`` is the equivalent of
``cv::warpPerspective(src, H, size, INTER_LINEAR, BORDER_CONSTANT, value)``,
of one image or of a batch with one homography each;
``torch.nn.functional.grid_sample`` is deliberately not used: its corner
conventions differ from the reference's pixel-centre map.  Like OpenCV,
``h`` maps SOURCE to DESTINATION pixels.  Both are plain tensor ops: the
JAX package computes them outside any Pallas kernel too.
"""

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

_SHEAR_PAD = 256   # max |per-line shift| the shear passes can absorb, px


def _shear_rows(planes: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-row fractional x-shift of (C, H, W) planes: out[c, y, x] =
    in[c, y, x + shifts[y]] (one contiguous window per row, then a 2-tap
    lerp); reads beyond the canvas clamp into a zero apron."""
    c, h, w = planes.shape
    fl = torch.floor(shifts)
    k = fl.to(torch.int64)
    f = (shifts - fl).to(planes.dtype)[None, :, None]
    s = _SHEAR_PAD
    padded = torch.nn.functional.pad(planes, (s, s + 1))          # (C, H, W + 2s + 1)
    start = (s + k).clamp(0, 2 * s)                                # in range for |k| <= s
    idx = start[:, None] + torch.arange(w + 1, device=planes.device)[None, :]
    shifted = torch.gather(padded, -1, idx.expand(c, h, w + 1))
    return shifted[:, :, :-1] * (1 - f) + shifted[:, :, 1:] * f


def _resample_axis(planes: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """1-D affine resample with one index vector shared along ``axis``:
    out[i] = in[scale · i + offset] (bilinear, clamped)."""
    n = planes.shape[axis]
    idx = torch.arange(n, dtype=planes.dtype, device=planes.device)
    # residual form i + i·(scale − 1): the exact integer part plus a small
    # product keeps the f32 rounding small across the extended canvas
    pos = idx + idx * (scale - 1.0) + offset
    i0 = torch.floor(pos)
    f = pos - i0
    i0c = i0.clamp(0, n - 1).long()
    i1c = (i0c + 1).clamp(0, n - 1)
    a = planes.index_select(axis, i0c)
    b = planes.index_select(axis, i1c)
    shape = [1] * planes.dim()
    shape[axis] = n
    f = f.reshape(shape)
    return a * (1 - f) + b * f


def warp_affine_shear(src: torch.Tensor, h: torch.Tensor,
                      border_value: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Affine warp of an (H, W) or (H, W, C) image by ``h`` (3, 3, src ->
    dst; the projective row is ignored) through the LDU shear
    decomposition: a y-shear, separable axis scales with the x-translation,
    an x-shear.  Requires |inv(A)[0, 0]| not tiny (|rotation| < ~60°) and
    per-line shifts within ±256 px, as stabilization corrections are;
    outside that use :func:`warp_perspective`.  ``border_value``: a number
    or (C,) fill outside the source."""
    src = src.float()
    has_c = src.dim() == 3
    planes = src.permute(2, 0, 1) if has_c else src[None]
    c, hh, ww = planes.shape
    dev = planes.device

    hinv = _inv3x3(h.float())
    a11, a12, tx = hinv[0, 0], hinv[0, 1], hinv[0, 2]
    a21, a22, ty = hinv[1, 0], hinv[1, 1], hinv[1, 2]
    a11s = torch.where(a11.abs() > 1e-3, a11, torch.full_like(a11, 1e-3))
    u = a12 / a11s
    l = a21 / a11s  # noqa: E741
    p = a11
    q = a22 - a21 * a12 / a11s
    ty2 = ty - l * tx

    pad = _SHEAR_PAD
    ext = torch.nn.functional.pad(planes, (pad, pad, pad, pad))

    # P1: y-shear, out1(x, y) = img(x, y + l·x + ty2), worked transposed so
    # the per-line window runs along the contiguous axis
    xs_ext = torch.arange(ww + 2 * pad, dtype=torch.float32, device=dev) - pad
    out1 = _shear_rows(ext.transpose(1, 2), (l * xs_ext + ty2) + 0.0).transpose(1, 2)

    # P2: separable axis scales + x-translation, out2(x, y) = out1(p·x + tx, q·y)
    out2 = _resample_axis(out1, q, (q - 1.0) * (-pad), axis=1)
    out2 = _resample_axis(out2, p, (p - 1.0) * (-pad) + tx, axis=2)

    # P3: x-shear, out3(x, y) = out2(x + u·y, y)
    ys_ext = torch.arange(hh + 2 * pad, dtype=torch.float32, device=dev) - pad
    out3 = _shear_rows(out2, u * ys_ext)
    warped = out3[:, pad:pad + hh, pad:pad + ww]

    # border mask from the true inverse map
    ys, xs = pixel_grid(hh, ww, dev)
    sx = a11 * xs + a12 * ys + tx
    sy = a21 * xs + a22 * ys + ty
    inb = (sx >= 0.0) & (sx <= ww - 1.0) & (sy >= 0.0) & (sy <= hh - 1.0)
    # a number stays a scalar operand: no copy to the device
    if isinstance(border_value, torch.Tensor):
        border_value = border_value.float().expand(c)[:, None, None]
    out = torch.where(inb[None], warped, border_value)
    return out.permute(1, 2, 0) if has_c else out[0]
