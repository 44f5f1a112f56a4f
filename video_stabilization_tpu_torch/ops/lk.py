"""Pyramidal sparse optical flow: the ``lk_track`` entry point and the
per-point trackers.

Port of ``video_stabilization_tpu/ops/lk.py``.  ``lk_track`` dispatches on
``LKConfig.method``: ``"dense"`` (``ops/lk_dense.py``), ``"sweep"`` (per
point: an SSD sweep over shared integer shifts at each coarse level, a
quadratic subpixel fit, and a few Newton iterations at level 0) and
``"cv2exact"`` (the fidelity referee: no sweep, OpenCV's zero-initialised
Newton descent with its whole iteration schedule and its oscillation exit
at every level, derivatives zero-padded outside the image as
``cv::buildOpticalFlowPyramid`` pads them).

Patches are read with the JAX package's index semantics, which decide the
values at windows that overhang the padded level: a row index below zero
wraps once (``+ H``) and then clamps, as ``x[idx]`` gathers; a window's
column start wraps once and clamps to ``[0, W − size]``, as
``lax.dynamic_slice``.  All of it is plain tensor ops, one pair per call;
a batch of pairs (levels (B, h, w), points (B, N, 2)) runs pair by pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from video_stabilization_tpu_torch.config import LKConfig


@dataclass
class LKResult:
    points: torch.Tensor   # (..., N, 2) f32 tracked locations
    status: torch.Tensor   # (..., N) bool
    error: torch.Tensor    # (..., N) f32 mean |residual| over the window


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of the last two axes (the edge
    pixel not repeated), for any ``pad``: wider pads than the image keep
    reflecting, with period 2·(n − 1)."""
    def index(n: int) -> torch.Tensor:
        i = torch.arange(-pad, n + pad, device=img.device)
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - i, i)

    return img.index_select(-2, index(img.shape[-2])).index_select(-1, index(img.shape[-1]))


def _gather_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """A JAX gather's index: negative wraps once, then clamps to [0, n)."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _slice_start(i: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``lax.dynamic_slice``'s start: negative wraps once, then clamps to
    [0, n − size]."""
    return torch.where(i < 0, i + n, i).clamp(0, n - size)


def _extract_patches(img: torch.Tensor, top_left: torch.Tensor, size: int) -> torch.Tensor:
    """(N, size, size) bilinear patches of the padded (H, W) ``img`` at the
    (N, 2) float top-left corners (x, y): the (size + 1)² integer block,
    blended with each point's fractional weights."""
    i0 = torch.floor(top_left)
    frac = top_left - i0
    y0 = i0[:, 1].long()
    x0 = i0[:, 0].long()
    span = torch.arange(size + 1, device=img.device)
    rows = _gather_index(y0[:, None] + span, img.shape[0])                 # (N, s+1)
    cols = _slice_start(x0, img.shape[1], size + 1)[:, None] + span          # (N, s+1)
    big = img[rows[:, :, None], cols[:, None, :]]
    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    return ((1 - fx) * (1 - fy) * big[:, :-1, :-1] + fx * (1 - fy) * big[:, :-1, 1:]
            + (1 - fx) * fy * big[:, 1:, :-1] + fx * fy * big[:, 1:, 1:])


def _scharr_patches(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr/32 gradients on the interior of (..., w+2, w+2) patches."""
    k0, k1, k2 = 3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0
    sm_rows = k0 * p[..., :-2, :] + k1 * p[..., 1:-1, :] + k2 * p[..., 2:, :]
    ix = sm_rows[..., :, 2:] - sm_rows[..., :, :-2]
    sm_cols = k0 * p[..., :, :-2] + k1 * p[..., :, 1:-1] + k2 * p[..., :, 2:]
    iy = sm_cols[..., 2:, :] - sm_cols[..., :-2, :]
    return ix, iy


def _ssd_displacement(region: torch.Tensor, templ: torch.Tensor, srange: int):
    """Integer + subpixel displacement minimizing SSD(window of region,
    templ): region (N, win + 2·srange, win + 2·srange), templ (N, win, win)
    -> (disp (N, 2) as (dx, dy), min_ssd (N,)).  SSD = ||w||² − 2<w, t> +
    ||t||², the shift-free term added last; one row of shifts per step."""
    n, win = templ.shape[0], templ.shape[1]
    side = 2 * srange + 1
    t2 = (templ * templ).sum((1, 2))
    rows = []
    for sy in range(side):
        w = region[:, sy:sy + win, :].unfold(2, win, 1).permute(0, 2, 1, 3)  # (N, side, win, win)
        rows.append((w * (w - 2.0 * templ[:, None])).sum((2, 3)))
    surface = torch.cat(rows, 1) + t2[:, None]                                # (N, side²)

    best = torch.argmin(surface, 1)                                            # first minimum
    by = best // side
    bx = best % side
    min_ssd = surface.gather(1, best[:, None])[:, 0]
    surf2 = surface.reshape(n, side, side)
    byc = by.clamp(1, side - 2)
    bxc = bx.clamp(1, side - 2)

    def fit(a, b, c):
        denom = a - 2.0 * b + c
        denom = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
        return (0.5 * (a - c) / denom).clamp(-0.5, 0.5)

    ridx = torch.arange(n, device=region.device)
    c0 = surf2[ridx, byc, bxc]
    sub_x = fit(surf2[ridx, byc, bxc - 1], c0, surf2[ridx, byc, bxc + 1])
    sub_y = fit(surf2[ridx, byc - 1, bxc], c0, surf2[ridx, byc + 1, bxc])
    # the subpixel fit only where the minimum is interior
    sub_x = torch.where(bx == bxc, sub_x, 0.0)
    sub_y = torch.where(by == byc, sub_y, 0.0)
    disp = torch.stack([bx.float() - srange + sub_x, by.float() - srange + sub_y], -1)
    return disp, min_ssd


def lk_track(pyr_prev: Sequence[torch.Tensor], pyr_next: Sequence[torch.Tensor],
             points: torch.Tensor, mask: torch.Tensor,
             config: LKConfig = LKConfig()) -> LKResult:
    """Track (N, 2) level-0 ``points`` from ``pyr_prev`` to ``pyr_next``, or
    a batch of pairs: levels (B, h, w), points (B, N, 2).  Dispatches on
    ``config.method`` (module docstring)."""
    if config.method == "dense":
        from video_stabilization_tpu_torch.ops.lk_dense import lk_track_dense

        return lk_track_dense(pyr_prev, pyr_next, points, mask, config)
    if pyr_prev[0].dim() == 3:
        res = [lk_track_sweep([p[b] for p in pyr_prev], [p[b] for p in pyr_next],
                              points[b], mask[b], config)
               for b in range(points.shape[0])]
        return LKResult(points=torch.stack([r.points for r in res]),
                        status=torch.stack([r.status for r in res]),
                        error=torch.stack([r.error for r in res]))
    return lk_track_sweep(pyr_prev, pyr_next, points, mask, config)


def lk_track_sweep(pyr_prev: Sequence[torch.Tensor], pyr_next: Sequence[torch.Tensor],
                   points: torch.Tensor, mask: torch.Tensor,
                   config: LKConfig = LKConfig()) -> LKResult:
    """Per-point tracker of (N, 2) level-0 ``points`` ("sweep", or with
    ``config.method == "cv2exact"`` the referee; module docstring)."""
    from video_stabilization_tpu_torch.ops.gradients import scharr_xy

    win = config.window_size
    half = (win - 1) / 2.0
    n_levels = len(pyr_prev) - 1
    n = points.shape[0]
    srange = 4                      # per-level search range (px)
    srange_top = 8                  # a wider sweep at the coarsest level
    polish_iters = 3
    eps2 = config.epsilon * config.epsilon
    cv2exact = config.method == "cv2exact"

    points = points.float()
    valid = mask.bool()
    dev = points.device
    # every level padded so that windows may overhang it; cv2 tracks windows
    # overhanging by up to winSize, so cv2exact pads win + 2
    pad = (win + 2) if cv2exact else (int(half) + srange_top + 3)
    pyr_prev_raw = pyr_prev
    pyr_prev = [reflect_pad(p.float(), pad) for p in pyr_prev]
    pyr_next = [reflect_pad(p.float(), pad) for p in pyr_next]

    g = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    status = valid
    err = torch.zeros((n,), dtype=torch.float32, device=dev)
    min_eig_ok = valid

    for level in range(n_levels, -1, -1):
        img_i = pyr_prev[level]
        img_j = pyr_next[level]
        h_l = img_i.shape[0] - 2 * pad
        w_l = img_i.shape[1] - 2 * pad
        p_l = points / (2.0 ** level)
        rng = srange_top if level == n_levels else srange

        # template patches and structure tensor
        if cv2exact:
            # cv2's derivatives come from the unpadded level, zero outside it
            ix_map, iy_map = scharr_xy(pyr_prev_raw[level])
            ix_map = torch.nn.functional.pad(ix_map, (pad, pad, pad, pad))
            iy_map = torch.nn.functional.pad(iy_map, (pad, pad, pad, pad))
            tl_p = p_l - half + pad
            ipatch = _extract_patches(img_i, tl_p, win)
            ix = _extract_patches(ix_map, tl_p, win)
            iy = _extract_patches(iy_map, tl_p, win)
        else:
            ipatch_big = _extract_patches(img_i, p_l - (half + 1.0) + pad, win + 2)
            ix, iy = _scharr_patches(ipatch_big)
            ipatch = ipatch_big[:, 1:-1, 1:-1]

        gxx = (ix * ix).sum((1, 2))
        gxy = (ix * iy).sum((1, 2))
        gyy = (iy * iy).sum((1, 2))
        det = gxx * gyy - gxy * gxy
        min_eig = 0.5 * (gxx + gyy) - torch.sqrt(torch.square(0.5 * (gxx - gyy)) + gxy * gxy)
        if cv2exact:
            # cv2's A matrix holds raw 3/10/3 Scharr sums x 2^-20 where
            # scharr_xy is /32-normalized: A_cv = g / 1024, and its
            # minEigThreshold and D >= FLT_EPSILON gates compare in that scale
            flt = 1.0 / 1024.0
            min_eig = min_eig * flt / (win * win)
            good_tensor = ((min_eig >= config.min_eig_threshold)
                           & (det * flt * flt >= 1.1920929e-07))
            # a point is lost only when a window's floor leaves
            # [-winSize, cols) x [-winSize, rows)
            def inside(fl):
                return ((fl[:, 0] >= -win) & (fl[:, 0] < w_l)
                        & (fl[:, 1] >= -win) & (fl[:, 1] < h_l))
            in_bounds = inside(torch.floor(p_l - half)) & inside(torch.floor(p_l + g - half))
        else:
            min_eig = min_eig / (win * win)
            good_tensor = (min_eig > config.min_eig_threshold) & (det > 1e-12)
            in_bounds = ((p_l[:, 0] >= 0.0) & (p_l[:, 1] >= 0.0)
                         & (p_l[:, 0] <= w_l - 1.0) & (p_l[:, 1] <= h_l - 1.0))
        level_ok = status & good_tensor & in_bounds
        if level == n_levels:
            min_eig_ok = good_tensor

        # SSD sweep over shared integer shifts (not at level 0, where the
        # coarse levels leave the flow inside the Newton basin)
        if level > 0 and not cv2exact:
            region = _extract_patches(img_j, p_l + g - (half + rng) + pad, win + 2 * rng)
            disp, _ = _ssd_displacement(region, ipatch, rng)
            v = torch.where(level_ok[:, None], disp, 0.0)
        else:
            v = torch.zeros_like(g)

        # Newton iterations (level 0 only; every level in cv2exact)
        if level == 0 or cv2exact:
            det_safe = torch.where(good_tensor, det, torch.ones_like(det))
            inv00 = gyy / det_safe
            inv01 = -gxy / det_safe
            inv11 = gxx / det_safe
            done = ~level_ok
            # +inf so the first iteration cannot trip the oscillation test
            prev_delta = torch.full((n, 2), torch.inf, dtype=torch.float32, device=dev)
            for _ in range(config.max_iters if cv2exact else polish_iters):
                jpatch = _extract_patches(img_j, p_l + g + v - half + pad, win)
                r = jpatch - ipatch
                bx = (r * ix).sum((1, 2))
                by = (r * iy).sum((1, 2))
                delta = torch.stack([-(inv00 * bx + inv01 * by),
                                     -(inv01 * bx + inv11 * by)], -1)
                act = level_ok & ~done
                if cv2exact:
                    # cv2's oscillation exit: two consecutive deltas nearly
                    # cancel -> take back half the last step and stop
                    osc = (((delta[:, 0] + prev_delta[:, 0]).abs() < 0.01)
                           & ((delta[:, 1] + prev_delta[:, 1]).abs() < 0.01))
                    step = torch.where((act & osc)[:, None], 0.5 * delta, delta)
                    v_new = v + torch.where(act[:, None], step, 0.0)
                    done_new = done | ((delta * delta).sum(-1) <= eps2) | osc
                else:
                    v_new = v + torch.where(act[:, None], delta, 0.0)
                    done_new = done | ((delta * delta).sum(-1) < eps2)
                err = torch.where(done, err, r.abs().mean((1, 2)))
                v, done, prev_delta = v_new, done_new, delta

        g = (2.0 * (g + v)) if level > 0 else (g + v)
        status = level_ok if level == 0 else status

    new_pts = points + g
    if cv2exact:
        # cv2 reports the tracked endpoint whatever the status, and loses a
        # point only by the per-level window bounds above
        return LKResult(points=new_pts, status=status, error=err)
    h0 = pyr_prev[0].shape[0] - 2 * pad
    w0 = pyr_prev[0].shape[1] - 2 * pad
    in_final = ((new_pts[:, 0] >= 0.0) & (new_pts[:, 1] >= 0.0)
                & (new_pts[:, 0] < w0) & (new_pts[:, 1] < h0))
    status = status & in_final & min_eig_ok
    return LKResult(points=torch.where(status[:, None], new_pts, points), status=status,
                    error=err)
