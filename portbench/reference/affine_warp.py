"""Affine warping as two 1-D bilinear resample passes (Catmull-Smith): a
frozen copy of the plain version of the program's ``ops/affine_warp.py``,
which the program's CUDA kernel (``csrc/affine_warp.cu``) equals bit for
bit.  With the inverse (dst->src) affine ``sx = A·x + B·y + tx``,
``sy = C·x + D·y + ty``::

    pass V:  I1[c, y, u]  = src[c, alpha·y + beta·u + gamma, u]
                 alpha = D − C·B/A,  beta = C/A,  gamma = ty − C·tx/A
    pass H:  out[c, y, x] = I1[c, y, A·x + B·y + tx]

The constant border comes from the true inverse map.  With the projective
fallback, a transform outside the rotation envelope (~9°) takes
:func:`~portbench.reference.warp.warp_perspective` instead; each warp's
branch is chosen on the host.  :func:`warp_affine` is
:func:`warp_affine_plain` on every device.
"""

from __future__ import annotations

import torch

from portbench.reference.warp import _inv3x3, pixel_grid, warp_perspective

# Envelope of the JAX package's full Pallas copy budget (pallas_warp.COPIES):
# |alpha-1|·8 + |beta|·128 + 3 <= COPIES for both passes, ~9° of rotation.
COPIES = 26


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

    if projective_fallback and not bool(_envelope_ok_inv(hinv)):
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




warp_affine = warp_affine_plain
