"""Dense block-matching pyramidal flow with global-similarity chaining.

Port of ``video_stabilization_tpu/ops/lk_dense.py`` (``lk_track_dense``):

1. a dense SSD sweep over shared integer shifts at the coarsest level;
2. at each finer level, the next frame warped by the current similarity
   (:func:`~video_stabilization_tpu_torch.ops.affine_warp.warp_affine`) and
   a dense residual (a small sweep at the first mid level, one Newton round
   below it) refit on a regular grid;
3. two dense Newton rounds at level 0;
4. one bilinear sample of the final maps at the query corners;
5. with ``corner_polish_iters > 0``, that many per-point Newton iterations
   at the exact corner positions, each step clipped to a 1.5 px trust
   region (a saturating step drops the point as independently moving).

The JAX package's ``_band`` and ``_extract_bilinear_mxu`` are matrix-unit
workarounds; here the box filter is an f32 banded matmul and the polish's
patches one gather of the bf16-rounded image (``ops/patches.py``; the one-hot contractions copy
bf16 entries exactly).  ``_box_same`` rounds exactly where the JAX version
does: its input, and its intermediate before the second axis, to bf16.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from video_stabilization_tpu_torch.config import LKConfig
from video_stabilization_tpu_torch.motion.similarity import fit_similarity_masked
from video_stabilization_tpu_torch.ops.affine_warp import warp_affine
from video_stabilization_tpu_torch.ops.gradients import scharr_xy
from video_stabilization_tpu_torch.ops.patches import extract_patches
from video_stabilization_tpu_torch.ops.warp import _inv3x3
from video_stabilization_tpu_torch.utils.stage_profile import stage


@functools.lru_cache(maxsize=32)
def _band(n: int, win: int, device: torch.device) -> torch.Tensor:
    """(n, n) f32 band: 1 iff j lies in the length-``win`` window of i."""
    h = win // 2
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return ((j >= i - h) & (j <= i - h + win - 1)).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _box_same(x: torch.Tensor, win: int) -> torch.Tensor:
    """win x win zero-padded SAME box sum of (..., H, W), with the JAX
    version's bf16 roundings of the input and of the intermediate."""
    hgt, wid = x.shape[-2], x.shape[-1]
    t = torch.matmul(_band(hgt, win, x.device), _bf16(x))
    return torch.matmul(_bf16(t), _band(wid, win, x.device).T)


def _dense_residual_flow(img_i: torch.Tensor, img_j: torch.Tensor, srange: int,
                         win: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense integer + parabola flow minimizing the win x win SSD of
    ``img_j`` shifted against ``img_i``, both (..., H, W) -> (flow (..., H,
    W, 2) as (dx, dy), interior (..., H, W) bool)."""
    h, w = img_i.shape[-2:]
    side = 2 * srange + 1
    jp = torch.nn.functional.pad(img_j, (srange, srange, srange, srange))
    shifted = torch.stack([jp[..., sy:sy + h, sx:sx + w]
                           for sy in range(side) for sx in range(side)], -3)
    surf = _box_same(torch.square(shifted - img_i[..., None, :, :]), win)

    amin = torch.argmin(surf, -3)                                # first minimum
    ay = amin // side
    ax = amin % side
    ayc = ay.clamp(1, side - 2)
    axc = ax.clamp(1, side - 2)

    def pick(dy, dx):
        idx = (ayc + dy) * side + (axc + dx)
        return torch.gather(surf, -3, idx[..., None, :, :])[..., 0, :, :]

    c0 = pick(0, 0)
    cxm, cxp = pick(0, -1), pick(0, 1)
    cym, cyp = pick(-1, 0), pick(1, 0)

    def fit(a, b, c):
        denom = a - 2.0 * b + c
        denom = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
        return (0.5 * (a - c) / denom).clamp(-0.5, 0.5)

    sub_x = torch.where(ax == axc, fit(cxm, c0, cxp), 0.0)
    sub_y = torch.where(ay == ayc, fit(cym, c0, cyp), 0.0)
    flow = torch.stack([ax.float() - srange + sub_x, ay.float() - srange + sub_y], -1)
    interior = (ax > 0) & (ax < side - 1) & (ay > 0) & (ay < side - 1)
    return flow, interior


def _structure(ix: torch.Tensor, iy: torch.Tensor, win: int):
    """Box-filtered structure tensor (gxx, gxy, gyy)."""
    return _box_same(ix * ix, win), _box_same(ix * iy, win), _box_same(iy * iy, win)


def _min_eig(gxx, gxy, gyy, win: int) -> torch.Tensor:
    half_tr = 0.5 * (gxx + gyy)
    disc = torch.sqrt(torch.square(0.5 * (gxx - gyy)) + torch.square(gxy))
    return (half_tr - disc) / float(win * win)


def _min_eig_dense(ix: torch.Tensor, iy: torch.Tensor, win: int) -> torch.Tensor:
    """Per-pixel smaller structure-tensor eigenvalue / win² (cv2 LK minEig)."""
    return _min_eig(*_structure(ix, iy, win), win)


def _apply_h(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Affine (..., 3, 3) applied to (..., N, 2) points (no projective
    divide)."""
    return pts @ h[..., :2, :2].mT + h[..., None, :2, 2]


def _scale_h(h: torch.Tensor, s: float) -> torch.Tensor:
    """Level-0 similarities (..., 3, 3) -> level with coordinates scaled by
    1/s."""
    out = h.clone()
    out[..., :2, 2] = h[..., :2, 2] / s
    return out


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, -1))


def _grid_fit(h_cur, flow, interior, min_eig, scale: float, min_eig_threshold: float,
              resid_px: float, vote_range: int = 9) -> torch.Tensor:
    """IRLS similarity refit of a dense residual flow (..., H, W, 2) on a
    regular grid, in level-0 coordinates; returns the updated similarities
    (..., 3, 3)."""
    hgt, wid = flow.shape[-3:-1]
    lead = flow.shape[:-3]
    dev = flow.device
    stride = max(4, min(hgt, wid) // 22)
    off = stride // 2
    ys = torch.arange(off, hgt, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(off, wid, stride, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    src_l = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)

    def grid(x):
        return x[..., off::stride, off::stride].reshape(lead + (-1,))

    margin = 10.0
    in_core = ((src_l[:, 0] >= margin) & (src_l[:, 0] < wid - margin)
               & (src_l[:, 1] >= margin) & (src_l[:, 1] < hgt - margin))
    f = flow[..., off::stride, off::stride, :].reshape(lead + (-1, 2))
    w0 = grid(interior) & in_core & (grid(min_eig) > min_eig_threshold)

    # plurality flow by unit-width histogram votes, then a gate around it
    wf = w0.float()
    bins = torch.arange(-vote_range, vote_range + 1, dtype=torch.float32, device=dev)
    votes = torch.sum(wf[..., None, :, None]
                      * ((f[..., None, :, :] - bins[:, None, None]).abs() < 1.0), -2)
    med = bins[torch.argmax(votes, -2)]                          # first maximum
    gate = torch.clamp(0.25 * _norm(med), min=1.8)
    w_med = (w0 & (_norm(f - med[..., None, :]) < gate[..., None])).float()

    dst_l = _apply_h(_scale_h(h_cur, scale), src_l + f)
    src0 = (src_l * scale).expand(dst_l.shape)
    dst0 = dst_l * scale
    h1, ok1 = fit_similarity_masked(src0, dst0, w_med)
    h1 = torch.where(ok1[..., None, None], h1, h_cur)
    r = _norm(_apply_h(h1, src0) - dst0)
    w1 = w_med * (r < resid_px * scale).float()
    h2, ok2 = fit_similarity_masked(src0, dst0, w1)
    return torch.where(ok2[..., None, None], h2, h1)


def _sample_maps(maps: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (..., K, H, W) maps at (..., N, 2) points ->
    (..., K, N)."""
    k, h, w = maps.shape[-3:]
    flat = maps.reshape(maps.shape[:-2] + (h * w,))
    x = pts[..., 0].clamp(0.0, w - 1.001)
    y = pts[..., 1].clamp(0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None, :]
    fy = (y - y0)[..., None, :]
    xi = x0.long()
    yi = y0.long()

    def tap(dy, dx):
        idx = ((yi + dy) * w + (xi + dx))[..., None, :]
        return torch.gather(flat, -1, idx.expand(idx.shape[:-2] + (k, idx.shape[-1])))

    return (tap(0, 0) * (1 - fx) * (1 - fy) + tap(0, 1) * fx * (1 - fy)
            + tap(1, 0) * (1 - fx) * fy + tap(1, 1) * fx * fy)


def _extract_bilinear(img: torch.Tensor, top_left: torch.Tensor, size: int) -> torch.Tensor:
    """(B, N, size, size) bilinear patches of the padded (B, H, W) ``img``
    at (B, N, 2) float top-left corners (x, y): the (size + 1)² block of the
    bf16-rounded image (``ops/patches.py``) at the corner's integer part,
    clipped into the image, blended with the corner's fractional weights."""
    h, w = img.shape[-2:]
    i0 = torch.floor(top_left)
    frac = top_left - i0
    y0 = i0[..., 1].long().clamp(0, h - (size + 1))
    x0 = i0[..., 0].long().clamp(0, w - (size + 1))
    big = torch.stack([extract_patches(img[b][None], y0[b], x0[b], size + 1)[:, 0]
                       for b in range(img.shape[0])])
    fx = frac[..., 0][..., None, None]
    fy = frac[..., 1][..., None, None]
    return ((1 - fx) * (1 - fy) * big[..., :-1, :-1] + fx * (1 - fy) * big[..., :-1, 1:]
            + (1 - fx) * fy * big[..., 1:, :-1] + fx * fy * big[..., 1:, 1:])


def _corner_polish(img_i, img_j, points, new_pts, saturated, iters: int, win: int):
    """``iters`` per-point Newton iterations of (B, N, 2) ``new_pts`` on the
    level-0 pair (B, h, w), from the templates at ``points``; returns the
    polished points and ``saturated`` with each point whose step left the
    1.5 px trust region."""
    from video_stabilization_tpu_torch.ops.lk import _scharr_patches, reflect_pad

    pad = win + 4
    img_i_p = reflect_pad(img_i, pad)
    img_j_p = reflect_pad(img_j, pad)
    half = (win - 1) / 2.0
    ipatch_big = _extract_bilinear(img_i_p, points - (half + 1.0) + pad, win + 2)
    pix, piy = _scharr_patches(ipatch_big)
    ipatch = ipatch_big[..., 1:-1, 1:-1]
    pgxx = (pix * pix).sum((-2, -1))
    pgxy = (pix * piy).sum((-2, -1))
    pgyy = (piy * piy).sum((-2, -1))
    pdet = pgxx * pgyy - pgxy * pgxy
    p_ok = pdet > 1e-12
    pdet_s = torch.where(p_ok, pdet, torch.ones_like(pdet))
    v = new_pts
    for _ in range(iters):
        r = _extract_bilinear(img_j_p, v - half + pad, win) - ipatch
        bx = (r * pix).sum((-2, -1))
        by = (r * piy).sum((-2, -1))
        step = torch.stack([-(pgyy * bx - pgxy * by) / pdet_s,
                            -(pgxx * by - pgxy * bx) / pdet_s], -1)
        # a saturating step: the dense estimate was off by more than the
        # clip, an independently moving point snapped to the global motion
        saturated = saturated | (p_ok & (step.abs().amax(-1) > 1.5))
        v = v + torch.where(p_ok[..., None], step.clamp(-1.5, 1.5), 0.0)
    return v, saturated


def _newton_delta(r, ix, iy, gxx, gxy, gyy, det_safe, ok, win):
    bx = _box_same(r * ix, win)
    by = _box_same(r * iy, win)
    dx = -(gyy * bx - gxy * by) / det_safe
    dy = -(gxx * by - gxy * bx) / det_safe
    return torch.where(ok[..., None], torch.stack([dx, dy], -1), 0.0)


def lk_track_dense(pyr_prev: Sequence[torch.Tensor], pyr_next: Sequence[torch.Tensor],
                   points: torch.Tensor, mask: torch.Tensor,
                   config: LKConfig = LKConfig()):
    """Track (N, 2) level-0 ``points`` from ``pyr_prev`` to ``pyr_next``;
    returns an ``LKResult``.

    A batch of B pairs: levels (B, h_l, w_l), ``points`` (B, N, 2) and
    ``mask`` (B, N) give a result with the leading B; each of the four
    warps is then one ``warp_affine`` of the whole batch.  One pair is the
    batch of one.  Stage ranges: ``lk_sweep`` (the top level's sweep and
    fit), ``lk_levels`` (the mid levels), ``lk_level0`` (level 0's Newton
    rounds) and ``lk_gate`` (the sampling and the gates)."""
    from video_stabilization_tpu_torch.ops.lk import LKResult

    if pyr_prev[0].dim() == 2:
        res = lk_track_dense([p[None] for p in pyr_prev], [p[None] for p in pyr_next],
                             points[None], mask[None], config)
        return LKResult(points=res.points[0], status=res.status[0], error=res.error[0])
    win = config.window_size
    thr = config.min_eig_threshold
    n_levels = len(pyr_prev) - 1
    with stage("lk_sweep"):
        points = points.float()
        valid = mask.bool()
        h0, w0 = pyr_prev[0].shape[-2:]
        dev = points.device
        t_cur = torch.eye(3, dtype=torch.float32, device=dev).expand(
            points.shape[:-2] + (3, 3))

        # coarse dense sweep at the top level only
        img_i, img_j = pyr_prev[n_levels], pyr_next[n_levels]
        rng = max(2, min(8, min(img_i.shape[-2:]) // 4))
        flow, interior = _dense_residual_flow(img_i, img_j, rng, win)
        me = _min_eig_dense(*scharr_xy(img_i), win)
        t_cur = _grid_fit(t_cur, flow, interior, me, float(2 ** n_levels), thr,
                          resid_px=max(1.5, rng / 2.0), vote_range=rng + 1)

    # mid levels: warp, residual (sweep at the first, Newton below), refit
    with stage("lk_levels"):
        for level in range(n_levels - 1, 0, -1):
            img_i, img_j = pyr_prev[level], pyr_next[level]
            scale = float(2 ** level)
            ix, iy = scharr_xy(img_i)
            me = _min_eig_dense(ix, iy, win)
            j_w = warp_affine(img_j, _inv3x3(_scale_h(t_cur, scale)), border_value=0.0,
                              projective_fallback=config.warp_fallback)
            if level == n_levels - 1:
                delta, ok = _dense_residual_flow(img_i, j_w, 3, win)
                ok = ok & (me > thr)
                vote_range = 4
            else:
                gxx, gxy, gyy = _structure(ix, iy, win)
                det = gxx * gyy - gxy * gxy
                ok = (me > thr) & (det > 1e-12)
                det_safe = torch.where(ok, det, torch.ones_like(det))
                delta = _newton_delta(j_w - img_i, ix, iy, gxx, gxy, gyy, det_safe, ok, win)
                vote_range = 3
            t_cur = _grid_fit(t_cur, delta, ok, me, scale, thr, resid_px=2.0,
                              vote_range=vote_range)

    # level 0: two dense Newton rounds with a refit between
    with stage("lk_level0"):
        img_i, img_j = pyr_prev[0], pyr_next[0]
        ix, iy = scharr_xy(img_i)
        gxx, gxy, gyy = _structure(ix, iy, win)
        det = gxx * gyy - gxy * gxy
        min_eig = _min_eig(gxx, gxy, gyy, win)
        good = (min_eig > thr) & (det > 1e-12)
        det_safe = torch.where(good, det, torch.ones_like(det))
        delta = err = None
        for rnd in range(2):
            j_w = warp_affine(img_j, _inv3x3(t_cur), border_value=0.0,
                              projective_fallback=config.warp_fallback)
            r = j_w - img_i
            delta = _newton_delta(r, ix, iy, gxx, gxy, gyy, det_safe, good, win)
            err = _box_same(r.abs(), win) / float(win * win)
            if rnd == 0:
                t_cur = _grid_fit(t_cur, delta, torch.ones_like(good), min_eig, 1.0, thr,
                                  resid_px=2.0, vote_range=3)

    # the maps at the corners, the optional polish, the status and cohort gates
    with stage("lk_gate"):
        samp = _sample_maps(torch.stack([delta[..., 0], delta[..., 1], err, min_eig], -3),
                            points)
        d_pts = samp[..., 0:2, :].mT
        err_pts = samp[..., 2, :]
        me_pts = samp[..., 3, :]
        new_pts = _apply_h(t_cur, points + d_pts)
        # independent-motion gate: a large residual delta after two Newton rounds
        saturated = d_pts.abs().amax(-1) > 1.5
        if config.corner_polish_iters > 0:
            new_pts, saturated = _corner_polish(img_i, img_j, points, new_pts, saturated,
                                                config.corner_polish_iters, win)

        in_final = ((new_pts[..., 0] >= 0.0) & (new_pts[..., 1] >= 0.0)
                    & (new_pts[..., 0] < w0) & (new_pts[..., 1] < h0))
        status = (valid & in_final & (me_pts > thr) & torch.isfinite(err_pts)
                  & torch.isfinite(new_pts).all(-1) & ~saturated)
        # residual-vs-cohort gate around the median error of each pair's valid
        # points
        n_pts = points.shape[-2]
        masked_err = torch.where(status, err_pts, torch.inf)
        cnt = status.to(torch.int64).sum(-1)
        mid = (cnt // 2).clamp(0, n_pts - 1)
        med = torch.sort(masked_err, -1).values.gather(-1, mid[..., None])[..., 0]
        med = torch.where(torch.isfinite(med), med, 0.0)
        status = status & (err_pts <= torch.clamp(5.0 * med, min=10.0)[..., None])
        out_pts = torch.where(status[..., None], new_pts, points)
    return LKResult(points=out_pts, status=status, error=err_pts)
