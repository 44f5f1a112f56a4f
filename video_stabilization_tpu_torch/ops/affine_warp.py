"""Affine warping as two 1-D bilinear resample passes (Catmull-Smith).

Port of ``video_stabilization_tpu/ops/pallas_warp.py``.  With the inverse
(dst->src) affine ``sx = A·x + B·y + tx``, ``sy = C·x + D·y + ty``::

    pass V:  I1[c, y, u]  = src[c, alpha·y + beta·u + gamma, u]
                 alpha = D − C·B/A,  beta = C/A,  gamma = ty − C·tx/A
    pass H:  out[c, y, x] = I1[c, y, A·x + B·y + tx]

The constant border comes from the true inverse map.  The JAX package picks
between two Pallas copy budgets and a projective gather by the transform's
rotation envelope (~9°); the port keeps the branch choice, so both packages
give the same values: inside :func:`affine_envelope_ok` the 2-pass result,
outside it :func:`~video_stabilization_tpu_torch.ops.warp.warp_perspective`.

:func:`warp_affine` on a CUDA tensor is one launch of the hand-written
kernel of ``csrc/affine_warp.cu``: it derives both passes' parameters and
the envelope branch on the device, fuses the passes through shared memory,
reads and writes the (H, W, C) layout in place, and reads nothing back to
the host; a warp outside the envelope adds one to :func:`fallback_counter`.
A batch of images, each with its own transform and border, is one launch
too (``h`` of shape (B, 3, 3)).  On a CPU tensor it is the plain version
:func:`warp_affine_plain`, built from :func:`resample_plain`, which decides
each warp's branch on the host.
"""

from __future__ import annotations

import ctypes

import torch

from video_stabilization_tpu_torch.ops.warp import _inv3x3, pixel_grid, warp_perspective
from video_stabilization_tpu_torch.utils.cuda_build import load_kernel

# Envelope of the JAX package's full Pallas copy budget (pallas_warp.COPIES):
# |alpha-1|·8 + |beta|·128 + 3 <= COPIES for both passes, ~9° of rotation.
COPIES = 26
# items of one launch: the grid's z extent
MAX_BATCH = 65535

# Launches of the CUDA kernel (one per warp or batch of warps) and
# plain-version warps that took the projective gather outside the envelope.
# Plain integers: a caller resets them and reads them around the run it
# wants to account for.  The CUDA warps outside the envelope are counted on
# the device (:func:`fallback_counter`), so that counting them reads nothing
# back.
launches = 0
gather_fallbacks = 0

_lib = None
_fallback_counters: dict = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_kernel("affine_warp")
        fn = lib.vstab_affine_warp
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fallback_counter(device) -> torch.Tensor:
    """The (1,) int32 device tensor that counts the CUDA warps on ``device``
    that took the projective gather.  A caller zeroes it (``.zero_()``)
    before the run it accounts for and reads it once after."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:     # plain "cuda": the current card
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _fallback_counters:
        _fallback_counters[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _fallback_counters[device]


def _positions(abg: torch.Tensor, n_out: int, n_l: int, device) -> torch.Tensor:
    """p[r, l] = (alpha·r + beta·l) + gamma, shape (n_out, n_l)."""
    r, l = pixel_grid(n_out, n_l, device)
    return (abg[0] * r + abg[1] * l) + abg[2]


def _border_mask(hinv: torch.Tensor, h: int, w: int, device) -> torch.Tensor:
    """(h, w) bool: the inverse map sends the output pixel inside the source."""
    ys, xs = pixel_grid(h, w, device)
    sx = hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]
    sy = hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]
    return (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)


def resample_plain(x: torch.Tensor, abg: torch.Tensor, n_out: int, axis: int,
                   hinv: torch.Tensor | None = None,
                   border: torch.Tensor | None = None) -> torch.Tensor:
    """One resample pass of the plain version.

    axis 0: x (C, n_in, L) -> (C, n_out, L), out[c, r, l] = x[c, p(r, l), l];
    axis 1: x (C, L, n_in) -> (C, L, n_out), out[c, l, r] = x[c, l, p(r, l)];
    bilinear in p, x zero outside its extent.  With ``hinv``/``border``
    (axis 1 only) pixels the inverse map sends outside the source take
    ``border[c]``."""
    c = x.shape[0]
    n_in = x.shape[1] if axis == 0 else x.shape[2]
    n_l = x.shape[2] if axis == 0 else x.shape[1]
    p = _positions(abg, n_out, n_l, x.device)            # (n_out, n_l)
    i0 = torch.floor(p)
    w = p - i0

    def tap(idx):
        ok = (idx >= 0.0) & (idx <= n_in - 1.0)
        ic = idx.clamp(0, n_in - 1).long()
        if axis == 0:
            v = torch.gather(x, 1, ic[None].expand(c, n_out, n_l))
            return torch.where(ok, v, 0.0)
        v = torch.gather(x, 2, ic.T[None].expand(c, n_l, n_out))
        return torch.where(ok.T, v, 0.0)

    v0 = tap(i0)
    v1 = tap(i0 + 1.0)
    wt = w if axis == 0 else w.T
    out = v0 * (1.0 - wt) + v1 * wt
    if hinv is not None:
        inb = _border_mask(hinv, n_l, n_out, x.device)
        out = torch.where(inb[None], out, border[:, None, None])
    return out


def _pass_params(hinv: torch.Tensor):
    """(pass V (alpha, beta, gamma), pass H (A, B, tx)), each (..., 3), from
    the (..., 3, 3) inverse map, with ``a_safe`` clamped as in the JAX
    package."""
    a, b, tx = hinv[..., 0, 0], hinv[..., 0, 1], hinv[..., 0, 2]
    cc, d, ty = hinv[..., 1, 0], hinv[..., 1, 1], hinv[..., 1, 2]
    a_safe = torch.where(a.abs() > 1e-3, a, torch.full_like(a, 1e-3))
    p_v = torch.stack([d - cc * b / a_safe, cc / a_safe, ty - cc * tx / a_safe], -1)
    p_h = torch.stack([a, b, tx], -1)
    return p_v, p_h


def _span_ok(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return (alpha - 1.0).abs() * 8.0 + beta.abs() * 128.0 + 3.0 <= COPIES


def _envelope_ok_inv(hinv: torch.Tensor) -> torch.Tensor:
    p_v, p_h = _pass_params(hinv)
    return (_span_ok(p_v[..., 0], p_v[..., 1]) & _span_ok(p_h[..., 0], p_h[..., 1])
            & (hinv[..., 0, 0].abs() > 1e-3))


def affine_envelope_ok(h: torch.Tensor) -> torch.Tensor:
    """(...) bool tensor: each (..., 3, 3) ``h`` lies inside the JAX
    package's Pallas envelope."""
    return _envelope_ok_inv(_inv3x3(h.float()))


def _warp_one_plain(src: torch.Tensor, h: torch.Tensor, border_value,
                    projective_fallback: bool) -> torch.Tensor:
    """The plain version on one (H, W) or (H, W, C) image."""
    src = src.float()
    has_c = src.dim() == 3
    planes = (src.permute(2, 0, 1) if has_c else src[None]).contiguous()
    c, hh, ww = planes.shape
    dev = planes.device
    hinv = _inv3x3(h.float())
    if isinstance(border_value, torch.Tensor):
        border = border_value.to(device=dev, dtype=torch.float32).expand(c).contiguous()
    else:
        border = torch.full((c,), float(border_value), dtype=torch.float32, device=dev)

    global gather_fallbacks
    if projective_fallback and not bool(_envelope_ok_inv(hinv)):
        gather_fallbacks += 1
        img = planes.permute(1, 2, 0)
        out = warp_perspective(img, h, None, 0.0).permute(2, 0, 1)
        out = torch.where(_border_mask(hinv, hh, ww, dev)[None], out,
                          border[:, None, None])
    else:   # pass V, then pass H with the border fused
        p_v, p_h = _pass_params(hinv)
        i1 = resample_plain(planes, p_v, hh, 0)
        out = resample_plain(i1, p_h, ww, 1, hinv[:2], border)
    return out.permute(1, 2, 0) if has_c else out[0]


def _batch_size(src: torch.Tensor, h: torch.Tensor) -> int | None:
    """B when ``h`` is a (B, 3, 3) batch of transforms, None for one (3, 3)
    transform; raises when ``src`` does not fit."""
    if h.dim() == 3 and h.shape[1:] == (3, 3):
        b = h.shape[0]
        if src.dim() not in (3, 4) or src.shape[0] != b:
            raise ValueError(f"warp_affine: a batch of {b} transforms takes src (B, H, W) or "
                             f"(B, H, W, C) with B = {b}, got {tuple(src.shape)}")
        return b
    if tuple(h.shape) != (3, 3):
        raise ValueError(f"warp_affine: h must be (3, 3) or (B, 3, 3), got {tuple(h.shape)}")
    if src.dim() not in (2, 3):
        raise ValueError(f"warp_affine: src must be (H, W) or (H, W, C), got "
                         f"{tuple(src.shape)}")
    return None


def _per_item_border(border_value, b: int, c: int):
    """An item's border is ``border_value`` (a number or (C,)) or its row
    of a (B, C) tensor."""
    if isinstance(border_value, torch.Tensor) and border_value.dim() == 2:
        if tuple(border_value.shape) != (b, c):
            raise ValueError(f"warp_affine: a per-item border must be ({b}, {c}), got "
                             f"{tuple(border_value.shape)}")
        return True
    return False


def warp_affine_plain(
    src: torch.Tensor,
    h: torch.Tensor,
    border_value: torch.Tensor | float = 0.0,
    *,
    projective_fallback: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_affine`, on any device.  Each
    warp's branch is chosen on the host (one read of its envelope
    predicate); a batch is its items' warps, one after the other."""
    b = _batch_size(src, h)
    if b is None:
        return _warp_one_plain(src, h, border_value, projective_fallback)
    c = src.shape[3] if src.dim() == 4 else 1
    per_item = _per_item_border(border_value, b, c)
    return torch.stack([
        _warp_one_plain(src[i], h[i], border_value[i] if per_item else border_value,
                        projective_fallback) for i in range(b)])


def warp_affine(
    src: torch.Tensor,
    h: torch.Tensor,
    border_value: torch.Tensor | float = 0.0,
    *,
    projective_fallback: bool = True,
) -> torch.Tensor:
    """Warp ``src`` ((H, W) or (H, W, C), any strides) by the affine ``h``
    (src->dst), bilinear, constant border; the projective row of ``h`` is
    ignored by the 2-pass path.  Returns a tensor of ``src``'s shape.

    A batch: ``h`` (B, 3, 3) warps each item of ``src`` (B, H, W) or (B, H,
    W, C) by its own transform, with ``border_value`` a number, (C,) or
    (B, C); ``h``'s shape tells a batch of one-channel images from one
    (H, W, C) image.

    ``projective_fallback`` takes the projective gather outside the
    envelope; without it the 2-pass resample always runs.  A CPU tensor goes
    to :func:`warp_affine_plain`; a CUDA tensor to one launch of the kernel
    for the whole batch, which raises rather than falls back if it cannot
    run."""
    if src.device.type == "cpu":
        return warp_affine_plain(src, h, border_value,
                                 projective_fallback=projective_fallback)
    if src.device.type != "cuda":
        raise ValueError(f"warp_affine: unsupported device {src.device}")
    b = _batch_size(src, h)
    if h.device != src.device:
        raise ValueError(f"warp_affine: h must be on {src.device}, got {h.device}")
    if b is not None and b > MAX_BATCH:
        raise ValueError(f"warp_affine: a batch of {b} exceeds the kernel's {MAX_BATCH}")
    src = src.float()
    items = src if b is not None else src[None]
    # the kernel addresses an item's elements by 32-bit offsets
    extent = sum((n - 1) * st for n, st in zip(items.shape[1:], items.stride()[1:]))
    if extent >= 2 ** 31:
        raise ValueError(f"warp_affine: an image spans {extent + 1} elements of memory, "
                         "more than the kernel's 2^31")
    c = items.shape[3] if items.dim() == 4 else 1
    border, border_stride, border_scalar = None, 0, 0.0
    if isinstance(border_value, torch.Tensor):
        border = border_value.to(device=src.device, dtype=torch.float32)
        if b is not None and _per_item_border(border, b, c):
            border, border_stride = border.contiguous(), c
        else:
            border = border.expand(c).contiguous()
    else:   # passed by value: no fill kernel
        border_scalar = float(border_value)
    hinv = _inv3x3(h.float()).reshape(-1, 3, 3).contiguous()
    out = _launch(items, hinv, border, border_stride, border_scalar, projective_fallback)
    return out if b is not None else out[0]


def _launch(src: torch.Tensor, hinv: torch.Tensor, border: torch.Tensor | None,
            border_stride: int, border_scalar: float,
            projective_fallback: bool) -> torch.Tensor:
    """One launch of the kernel on the float32 CUDA batch ``src`` (B, H, W)
    or (B, H, W, C) with the contiguous (B, 3, 3) inverse maps ``hinv`` and
    the border: ``border`` holds item 0's (C,) values and each next item's
    ``border_stride`` elements on (0: one border for all), or, if None,
    ``border_scalar``.  Returns the contiguous output."""
    dev = src.device
    bsz, hh, ww = src.shape[0], src.shape[1], src.shape[2]
    out = torch.empty(src.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # element strides (item, channel, row, column); a 3-d batch is one channel
    c = src.shape[3] if src.dim() == 4 else 1
    s_b, s_y, s_x = src.stride(0), src.stride(1), src.stride(2)
    s_c = src.stride(3) if src.dim() == 4 else 0
    o_b, o_y, o_x = out.stride(0), out.stride(1), out.stride(2)
    o_c = out.stride(3) if out.dim() == 4 else 0
    # the entry point makes the tensors' device current for the launch
    err = _kernel_lib().vstab_affine_warp(
        src.data_ptr(), out.data_ptr(), hinv.data_ptr(),
        border.data_ptr() if border is not None else None, border_scalar,
        fallback_counter(dev).data_ptr(), s_b, s_c, s_y, s_x, o_b, o_c, o_y, o_x,
        border_stride, bsz, c, hh, ww, int(projective_fallback), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"affine_warp launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
