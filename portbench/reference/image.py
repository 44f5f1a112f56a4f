"""Colour conversion, bilinear and nearest resize (OpenCV conventions).

Port of ``video_stabilization_tpu/ops/image.py`` (``bgr_to_gray``,
``gray_u8_cv2exact``, ``yuv_planes_to_bgr``, ``yuv_flat_to_bgr``,
``resize_bilinear``, ``resize_nearest``): BT.601 gray, cv2's exact integer
u8 gray for the reference-compat referee, cv2 INTER_LINEAR sampling at
``(dst + 0.5)·scale − 0.5`` clamped to the border, and INTER_NEAREST at
``floor(dst·scale)``.  Integer downscales take the strided-slice path
(1080 -> 360 is k = 3: a pure stride).  The YUV decode is plain tensor ops
on the frame's device: one f32 product or sum per op, as the native
reader's C++ rounds it.
"""

from __future__ import annotations

import torch


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) float32 gray."""
    img = img.float()
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def yuv_planes_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """YUV -> BGR uint8 on the planes' device: BT.601, the inverse of
    ``io.video.VideoWriter``'s forward transform, rounded as the native
    reader rounds it (``native/framebuf.cpp`` ``y4m_read_bgr``: clamp, +0.5,
    truncate).  ``y`` is (..., H, W); ``u`` / ``v`` are (..., H, W) or C420
    (..., H/2, W/2), upsampled by repeating each sample 2x2."""
    yf = y.float()
    if u.shape[-1] != y.shape[-1]:
        h, w = y.shape[-2], y.shape[-1]
        u = u.repeat_interleave(2, -1).repeat_interleave(2, -2)[..., :h, :w]
        v = v.repeat_interleave(2, -1).repeat_interleave(2, -2)[..., :h, :w]
    uf = u.float() - 128.0
    vf = v.float() - 128.0
    r = yf + 1.403 * vf
    g = yf - 0.344 * uf - 0.714 * vf
    b = yf + 1.773 * uf
    bgr = torch.stack([b, g, r], -1)
    return torch.floor(bgr.clamp(0.0, 255.0) + 0.5).to(torch.uint8)


def yuv_flat_to_bgr(buf: torch.Tensor, h: int, w: int, c420: bool) -> torch.Tensor:
    """(..., nbytes) packed Y|U|V uint8 (``NativeY4MReader.read_yuv``'s
    layout) -> (..., H, W, 3) BGR uint8 on the buffer's device."""
    if c420 and (h % 2 or w % 2):
        # the chroma planes are (h/2)·(w/2) = h·w/4 bytes only for even
        # sizes; the native reader refuses the others too
        raise ValueError(f"C420 requires even dimensions, got {h}x{w}")
    ysize = h * w
    csize = ysize // 4 if c420 else ysize
    ch, cw = (h // 2, w // 2) if c420 else (h, w)
    lead = tuple(buf.shape[:-1])
    y = buf[..., :ysize].reshape(lead + (h, w))
    u = buf[..., ysize:ysize + csize].reshape(lead + (ch, cw))
    v = buf[..., ysize + csize:].reshape(lead + (ch, cw))
    return yuv_planes_to_bgr(y, u, v)


def _linear_weights(dst_size: int, src_size: int, device):
    scale = src_size / dst_size
    x = (torch.arange(dst_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    x0 = torch.floor(x)
    frac = torch.where(x < 0, 0.0, x - x0)
    i0 = x0.clamp(0, src_size - 1).long()
    i1 = (i0 + 1).clamp(0, src_size - 1)
    return i0, i1, frac


def _resample_linear_1d(img: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """One axis of a cv2-INTER_LINEAR resize; integer factors are slices."""
    axis = axis % img.dim()
    src_size = img.shape[axis]
    if src_size == out_size:
        return img
    if src_size % out_size == 0:
        k = src_size // out_size
        limit = (out_size - 1) * k + 1
        if k % 2 == 1:
            start = (k - 1) // 2
            return img.narrow(axis, start, limit)[(slice(None),) * axis + (slice(None, None, k),)]
        a = img.narrow(axis, k // 2 - 1, limit)[(slice(None),) * axis + (slice(None, None, k),)]
        b = img.narrow(axis, k // 2, limit)[(slice(None),) * axis + (slice(None, None, k),)]
        return 0.5 * (a + b)
    i0, i1, f = _linear_weights(out_size, src_size, img.device)
    a = img.index_select(axis, i0)
    b = img.index_select(axis, i1)
    shape = [1] * img.dim()
    shape[axis] = out_size
    f = f.reshape(shape)
    return a * (1.0 - f) + b * f


def _hw_axes(img: torch.Tensor) -> tuple[int, int]:
    has_c = img.dim() >= 3 and img.shape[-1] in (1, 3, 4) and img.shape[-2] > 4
    return (-3, -2) if has_c else (-2, -1)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) or (..., H, W, C) images to float32."""
    h_axis, w_axis = _hw_axes(img)
    img = img.float()
    img = _resample_linear_1d(img, out_h, h_axis)
    return _resample_linear_1d(img, out_w, w_axis)


